"""The metric readers and the yardstick's arithmetic on inputs whose answer
is known."""

from types import SimpleNamespace

import numpy as np
import pytest

from slambench import devtrace, harness, reference, roofline


def test_frames_per_s_is_every_frame_over_the_window():
    rec = harness.RunRecord(frame_s=[0.1] * 90 + [1.0] * 10, window_s=19.0)
    assert harness.metric_reader("frames_per_s")(rec) == pytest.approx(100 / 19.0)


def test_p95_is_over_every_frame_with_a_stall():
    # 190 frames of 50 ms and 10 stalls of 2 s: the 95th percentile falls on
    # the stalls' edge, between the two
    times = [0.05] * 190 + [2.0] * 10
    rec = harness.RunRecord(frame_s=times, window_s=sum(times))
    p95 = harness.metric_reader("frame_ms_p95")(rec)
    assert p95 == pytest.approx(np.percentile(np.asarray(times) * 1e3, 95))
    assert 50.0 < p95 < 2000.0
    rec = harness.RunRecord(frame_s=[0.05] * 180 + [2.0] * 20, window_s=1.0)
    assert harness.metric_reader("frame_ms_p95")(rec) == pytest.approx(2000.0)


def test_p99_falls_among_heavy_frames_one_in_twenty():
    # 1 heavy frame in 20 (a closure every 20 frames): the 99th percentile is
    # a heavy frame's time, where the 95th sits on the heavy frames' edge
    times = ([0.08] * 19 + [0.5]) * 22
    rec = harness.RunRecord(frame_s=times, window_s=sum(times))
    assert harness.metric_reader("frame_ms_p99")(rec) == pytest.approx(500.0)
    assert harness.metric_reader("frame_ms_p99")(rec) == pytest.approx(
        np.percentile(np.asarray(times) * 1e3, 99))
    assert harness.metric_reader("frame_ms_p95")(rec) < 500.0


def test_ate_reads_only_the_prefix():
    gt = np.tile(np.eye(4), (10, 1, 1))
    gt[:, 0, 3] = np.arange(10.0)
    est = [T.copy() for T in gt[3:6]]
    est[1][1, 3] += 0.3                         # one prefix pose 0.3 m off
    assert reference.ate_rmse(est, gt, 3) == pytest.approx(np.sqrt(0.09 / 3))
    # what follows the prefix does not enter
    assert reference.ate_rmse(est[:2], gt, 3) == pytest.approx(np.sqrt(0.09 / 2))


def test_pose_numbers():
    gt = np.tile(np.eye(4), (5, 1, 1))
    gt[:, 0, 3] = np.arange(5.0)
    est = [T.copy() for T in gt]
    est[4] = est[4].copy()
    est[4][0, 3] += 0.5
    n = reference.pose_numbers(est, gt)
    assert n["pose_err_max_m"] == pytest.approx(0.5)
    assert n["rpe_max_m"] == pytest.approx(0.5)


def test_bound_and_decode_flops_give_path_b_train_row():
    # PERF.md's kernel table, train_iter on path B: B 16384, k 6, per
    # neighbour, F 8, H 64, VD 3: 0.0063 ms, bound by the operations
    assert roofline.decode_flops(8, 64, 3) == 4288
    flops, nbytes = roofline.train_iteration_work(16384, 6, 8, 64, 3, 0, False)
    ms, by = roofline.bound(nbytes, flops)
    assert by == "operations" and round(ms, 4) == 0.0063


def _ev(name, start, end, device, id_=0, annotation=False):
    import torch

    dt = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt, id=id_, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end,
                                                      elapsed_us=lambda s=start, e=end: e - s))


def test_trace_reduction_busy_idle_and_span_time():
    ev = [
        _ev(devtrace.FRAME_SPAN, 0, 1000, False),
        _ev("slambench.training", 100, 600, False),
        _ev("slambench.odometry", 700, 900, False),
        _ev("cudaLaunchKernel", 150, 160, False, id_=1),
        _ev("cudaLaunchKernel", 750, 760, False, id_=2),
        _ev("void train_iter_kernel<8>(float const*)", 200, 400, True, id_=1),
        _ev("void train_iter_kernel<8>(float const*)", 300, 500, True, id_=1),   # overlaps
        _ev("memcpy", 800, 850, True, id_=2),
        _ev("slambench.training", 100, 600, True, annotation=True),             # not work
    ]
    out = devtrace.reduce_trace(ev, ["slambench.training", "slambench.odometry"], 1)
    assert out["window_s"] == pytest.approx(1000e-6)
    assert out["busy_s"] == pytest.approx(350e-6)          # union: 200-500 and 800-850
    assert out["device_ops"] == 3
    assert out["top_ops"][0] == ["train_iter_kernel", pytest.approx(400e-6)]
    idle = dict(out["idle_gaps"])
    # each gap goes to the innermost span around its midpoint: 0-200 (100,
    # in training), 500-800 (650) and 850-1000 (925), in the frame alone
    assert idle["slambench.training"] == pytest.approx(200e-6)
    assert idle[devtrace.FRAME_SPAN] == pytest.approx(450e-6)
    assert out["device_s_by_span"]["slambench.training"] == pytest.approx(400e-6)
    rec = harness.RunRecord(trace=out, traced_train_work=(0.0, 0.0))
    assert harness.metric_reader("device_idle_share")(rec) == pytest.approx(65.0)
    assert harness.metric_reader("gpu_launches_per_frame")(rec) == 3
    assert harness.metric_reader("train_roofline_share")(rec) is None   # nothing counted


def test_readers_return_nothing_when_there_is_nothing_to_read():
    rec = harness.RunRecord()
    for name in ("frames_per_s", "frame_ms_p95", "frame_ms_p99", "stage_ms.odometry",
                 "train_roofline_share", "frame_mfu", "device_idle_share",
                 "gpu_launches_per_frame"):
        assert harness.metric_reader(name)(rec) is None, name


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax.numpy", "pin_slam_tpu.slam", "pin_slam_torch.slam", "jaxtyping", "flax"]
    assert harness.forbidden_loaded(mods) == ["flax", "jax.numpy", "pin_slam_tpu.slam"]
