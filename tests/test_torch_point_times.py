"""Per-point times handed to the port with scans held in memory, and the
deskew they drive, held to the benchmark's plain reference
(``slambench/reference_deskew_ba.py``): a five-column scan (x, y, z,
intensity, time) deskews with its own times, three- and four-column scans
read as files without times do, the deskew's span and count appear in the
frame's report only where a frame deskews, the benchmark's readers of them,
and the timed generator's times."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from pin_slam_torch.config import Config
from pin_slam_torch.dataset import io as pio
from pin_slam_torch.dataset.slam_dataset import SLAMDataset, recover_point_ts
from pin_slam_torch.ops.transforms import deskew_points
from pin_slam_torch.utils import tracing
from slambench import harness
from slambench import reference_deskew_ba as rd

F64 = torch.float64


def _rel_pose(rng, angle, shift=0.15):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) / np.sqrt(3) * angle).as_matrix()
    T[:3, 3] = rng.normal(size=3) * shift
    return T


def _sweep(rng, n, counter_clockwise=False):
    """A spinning sweep's points (n, 3) float32 and the time (n,) each fired:
    clockwise from azimuth pi, as ``recover_point_ts`` assumes, or the other
    way round."""
    s = np.sort(rng.uniform(0.0, 1.0, n))
    az = np.pi * (1.0 - 2.0 * s)
    if counter_clockwise:
        az = -az
    el = rng.uniform(-0.15, 0.15, n)
    r = rng.uniform(2.0, 50.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1).astype(np.float32)
    return pts, s.astype(np.float32)


def _dataset(scans, deskew=True, motion=None, **kw):
    cfg = Config()
    cfg.deskew = deskew
    cfg.min_range, cfg.max_range, cfg.min_z = 1.5, 60.0, -10.0
    cfg.frame_bucket = 1 << 13
    for k, v in kw.items():
        setattr(cfg, k, v)
    ds = SLAMDataset(cfg, scans=scans, device="cpu")
    if motion is not None:
        ds.processed_frame, ds.last_odom_tran = 1, motion.copy()
    return ds


def test_five_column_scans_hand_their_times():
    """A sweep fired counter-clockwise: the times recovered from the azimuth
    would run backwards, the handed ones are right; the frame deskews to the
    reference's answer from the handed times."""
    rng = np.random.default_rng(3)
    pts, s = _sweep(rng, 5000, counter_clockwise=True)
    scan = np.concatenate([pts, rng.uniform(0, 1, (5000, 1)), s[:, None]], 1).astype(np.float32)
    motion = _rel_pose(rng, 0.08)
    frame = _dataset([scan], motion=motion).preprocess_frame(0)
    n = frame.raw_count
    assert n == 5000 and frame.valid[:n].all()
    np.testing.assert_array_equal(frame.point_ts[:n], s)
    want = rd.deskew(torch.as_tensor(pts), torch.as_tensor(s),
                     torch.as_tensor(motion.astype(np.float32))).numpy()
    assert np.linalg.norm(frame.points[:n] - want, axis=1).max() < 2e-5
    # the azimuth's times are wrong for this sweep: their deskew lands elsewhere
    wrong = rd.deskew(torch.as_tensor(pts), torch.as_tensor(recover_point_ts(pts)),
                      torch.as_tensor(motion)).numpy()
    assert np.linalg.norm(wrong - want, axis=1).max() > 0.05


@pytest.mark.parametrize("deskew", [False, True], ids=["plain", "deskew"])
@pytest.mark.parametrize("columns", [3, 4])
def test_three_and_four_column_scans_read_as_before(tmp_path, columns, deskew):
    """A scan of three or four columns gives, bit for bit, the Frame the same
    points give read from a PLY file without times (the times recovered from
    the azimuth under deskew, none without), and a fifth column changes
    nothing of a frame that does not deskew but its ``point_ts``."""
    rng = np.random.default_rng(11)
    pts, _ = _sweep(rng, 4000)
    inten = rng.uniform(0, 1, (4000, 1)).astype(np.float32)
    scan = np.concatenate([pts, inten], 1)[:, :columns]
    pio.write_ply(str(tmp_path / "000000.ply"), pts, extra={"intensity": inten[:, 0]})
    motion = _rel_pose(rng, 0.05)
    mem = _dataset([scan], deskew, motion).preprocess_frame(0)
    disk = _dataset(None, deskew, motion, pc_path=str(tmp_path)).preprocess_frame(0)
    assert mem.raw_count == disk.raw_count == 4000
    np.testing.assert_array_equal(mem.points, disk.points)
    np.testing.assert_array_equal(mem.valid, disk.valid)
    if deskew:
        np.testing.assert_array_equal(mem.point_ts, disk.point_ts)
    else:
        assert mem.point_ts is None and disk.point_ts is None
        five = np.concatenate([pts, inten, np.zeros_like(inten)], 1)
        timed = _dataset([five], deskew, motion).preprocess_frame(0)
        np.testing.assert_array_equal(timed.points, mem.points)
        np.testing.assert_array_equal(timed.point_ts[:4000], np.zeros(4000, np.float32))


@pytest.mark.parametrize("angle", [0.0, 1e-6, 0.05, 0.3])
def test_deskew_points_against_reference(angle):
    """``ops.transforms.deskew_points`` (quaternion slerp, float32) against
    the reference's (exp(u log R), float64) within 2e-5 m on points to 50 m;
    a deskew without the slerp is farther off than that wherever the motion
    turns."""
    rng = np.random.default_rng(int(angle * 1e6) + 1)
    pts, s = _sweep(rng, 20000)
    ts = s * 0.1 + 3.0                       # any scale: both normalise min to max
    motion = _rel_pose(rng, angle)
    got = deskew_points(torch.as_tensor(pts), torch.as_tensor(ts),
                        torch.as_tensor(motion, dtype=torch.float32)).double()
    want = rd.deskew(torch.as_tensor(pts), torch.as_tensor(ts),
                     torch.as_tensor(motion, dtype=torch.float32))
    assert float(torch.linalg.norm(got - want, dim=1).max()) < 2e-5
    u = torch.as_tensor((s - s.min()) / (s.max() - s.min()) - 0.5, dtype=F64)
    no_slerp = torch.as_tensor(pts, dtype=F64) + u[:, None] * torch.as_tensor(motion[:3, 3])
    if angle >= 0.05:
        assert float(torch.linalg.norm(no_slerp - want, dim=1).max()) > 0.1


def test_reference_rotation_exp_log():
    rng = np.random.default_rng(2)
    for angle in (0.0, 1e-9, 0.3, 2.5):
        w = torch.as_tensor(rng.normal(size=3), dtype=F64)
        w = w / torch.linalg.norm(w) * angle
        R = rd.rotation_exp(w)
        assert torch.allclose(R @ R.T, torch.eye(3, dtype=F64), atol=1e-12)
        assert torch.allclose(rd.rotation_log(R), w, atol=1e-9)
    xi = torch.as_tensor(rng.normal(size=(3, 6)) * 0.2, dtype=F64)
    T = rd.se3_exp(xi)
    assert torch.allclose(T[:, :3, :3], rd.rotation_exp(xi[:, :3]), atol=1e-12)
    assert torch.equal(T[:, 3], torch.tensor([0.0, 0, 0, 1], dtype=F64).expand(3, 4))


def test_deskew_span_and_count_only_where_a_frame_deskews():
    """The deskew's span (inside the preprocess span) and the counts of its
    uploads and read-back reach the next frame's report; a KITTI-like frame (three columns,
    no deskew) adds no span, count or sync of the dataset but the
    preprocess span."""
    rng = np.random.default_rng(5)
    pts, s = _sweep(rng, 3000)
    five = np.concatenate([pts, np.zeros((3000, 1), np.float32), s[:, None]], 1)
    ds = _dataset([five], motion=_rel_pose(rng, 0.05))
    with tracing.frame(0):                   # closes what earlier calls measured
        pass
    ds.preprocess_frame(0)
    with tracing.frame(1) as report:
        pass
    assert report["counts"] == {"sync.dataset.points": 1, "sync.dataset.times": 1,
                                "sync.dataset.motion": 1, "sync.dataset.deskewed": 1}
    spans = report["span_ms"]
    assert {"pin_slam.dataset.preprocess", "pin_slam.dataset.deskew"} <= set(spans)
    assert spans["pin_slam.dataset.deskew"] <= spans["pin_slam.dataset.preprocess"]

    kitti = _dataset([pts], deskew=False, motion=_rel_pose(rng, 0.05))
    kitti.preprocess_frame(0)
    with tracing.frame(2) as report:
        pass
    assert report["counts"] == {} and report["wait_ms"] == {}
    assert set(report["span_ms"]) == {"pin_slam.dataset.preprocess", "pin_slam.frame"}


def _report(span_ms=None, counts=None):
    return {"frame_id": 0, "span_ms": span_ms or {}, "counts": counts or {}, "wait_ms": {},
            "launches": {}}


def test_readers_of_deskew_and_ba():
    frames = [_report(span_ms={"pin_slam.dataset.deskew": 3.0, "pin_slam.pgo.ba.loop": 600.0},
                      counts={"ba.iters": 60, "sync.dataset.points": 1}),
              _report(span_ms={"pin_slam.dataset.deskew": 2.0}),
              _report(span_ms={"pin_slam.dataset.deskew": 4.0, "pin_slam.pgo.ba.loop": 300.0},
                      counts={"ba.iters": 60})]
    run = harness.RunRecord(infos=[{"trace": f} for f in frames] + [{"skipped": True}])
    assert harness.metric_reader("stage_ms.deskew")(run) == pytest.approx(3.0)
    assert harness.metric_reader("ba_ms_per_iter")(run) == pytest.approx(900.0 / 120)
    # a cell that neither deskews nor adjusts (KITTI's), and the parent's
    # frames without reports: nothing to read
    kitti = harness.RunRecord(infos=[{"trace": _report(span_ms={"pin_slam.odometry": 9.0})}])
    for name in ("stage_ms.deskew", "ba_ms_per_iter"):
        assert harness.metric_reader(name)(kitti) is None
        assert harness.metric_reader(name)(harness.RunRecord(infos=[{}])) is None


def test_timed_generator_hands_each_points_column_time():
    """``lidar_scene_timed``'s scans: ``lidar_scene``'s points bit for bit,
    intensity 0, and each point's time the time its column fired (the
    column found again from the point's azimuth)."""
    from slambench.generators import lidar_scene, lidar_scene_timed

    spec = harness.load_cell("ncd_os0_128.quad")
    sensor = {**spec.config["sensor"], "blocks": [[45.0, -45.0, 16]], "columns": 128}
    seq = lidar_scene_timed.make(sensor, spec.traffic, 17, "cpu").sequence(3)
    base = lidar_scene.make(sensor, spec.traffic, 17, "cpu").sequence(3)
    C = sensor["columns"]
    for timed, plain in zip(seq.scans, base.scans):
        assert timed.shape == (plain.shape[0], 5) and timed.dtype == np.float32
        np.testing.assert_array_equal(timed[:, :3], plain)
        assert not timed[:, 3].any()
        az = np.arctan2(timed[:, 1].astype(np.float64), timed[:, 0].astype(np.float64))
        col = np.clip(np.round((1.0 - az / np.pi) / 2.0 * C - 0.5), 0, C - 1)
        np.testing.assert_array_equal(timed[:, 4], ((col + 0.5) / C).astype(np.float32))
    np.testing.assert_array_equal(seq.gt_poses, base.gt_poses)


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import slambench.reference_deskew_ba, slambench.generators.lidar_scene_timed\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pin_slam_torch', 'pin_slam_tpu', 'jax', 'jaxlib', 'flax')))\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
