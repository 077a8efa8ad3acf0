"""The port's in-program tracer (pin_slam_torch.utils.tracing) on the CPU:
the report each ``SlamSystem.process_frame`` returns, its counts of host
syncs and Gauss-Newton iterations charged to the right stage, the stage
spans behind ``stage_times``, the spans' nesting under torch.profiler, no
``record_function`` without a profiler, and the benchmark's readers of the
report (``slambench/metrics``) on hand-made records.

The sequences are the pipeline tests' tiny synthetic scenes: the corridor
drive and back with PGO on (a forced loop at frame 8, verified by
registration), and the straight drive with PGO off."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_pipeline import _config, _frames
from test_torch_pipeline_pgo import CLOSE_AT, LOOP_TO, _pgo_config, _revisit_frames

torch.set_num_threads(1)
STAGES = ("upload", "odometry", "map_update", "training", "pgo")


def _system(cfg):
    from pin_slam_torch.slam.pipeline import SlamSystem

    system = SlamSystem(cfg, device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    return system


def _syncs(report, stage):
    return sum(n for key, n in report["counts"].items() if key.startswith(f"sync.{stage}."))


@pytest.fixture(scope="module")
def pgo_run():
    """The corridor with PGO on, detection every other frame, the local
    detector forced to name frame 2 at frame 8: (system, infos)."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.slam import pipeline as tpl

    def forced(poses, travel, fid, *a, **k):
        return (LOOP_TO, 0.1) if fid == CLOSE_AT else (-1, np.inf)

    mp = pytest.MonkeyPatch()
    mp.setattr(tpl.ld, "detect_local_loop", forced)
    try:
        system = _system(_pgo_config(Config))
        infos = [system.process_frame(Frame(arr, valid, n))
                 for arr, valid, n in _revisit_frames()[:CLOSE_AT + 1]]
    finally:
        mp.undo()
    return system, infos


@pytest.fixture(scope="module")
def plain_run():
    """The straight drive with PGO off: (system, infos of frames 0-2)."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame

    system = _system(_config(Config, False))
    infos = [system.process_frame(Frame(arr, valid, n)) for arr, valid, n in _frames(3)]
    return system, infos


def test_every_frame_reports(pgo_run, plain_run):
    for system, infos in (pgo_run, plain_run):
        for i, info in enumerate(infos):
            tr = info["trace"]
            assert tr["frame_id"] == i
            assert set(tr) == {"frame_id", "span_ms", "counts", "wait_ms", "launches"}
            assert tr["span_ms"]["pin_slam.frame"] > 0.0
            assert tr["launches"] == {}          # the CPU launches no hand-written kernel
            assert "pgo_s" not in info


def test_gn_fetch_once_an_iteration_and_once_for_the_statistics(pgo_run, plain_run):
    for system, infos in (pgo_run, plain_run):
        for info in infos[1:]:
            counts = info["trace"]["counts"]
            assert counts["sync.odometry.gn_fetch"] == info["reg_iters"] + 1
            assert info["trace"]["span_ms"]["pin_slam.odometry.probe"] > 0.0
        assert "reg_iters" not in infos[0]
        assert "sync.odometry.gn_fetch" not in infos[0]["trace"]["counts"]


def test_no_pgo_syncs_on_frame_zero_nor_without_pgo(pgo_run, plain_run):
    assert _syncs(pgo_run[1][0]["trace"], "pgo") == 0
    for info in plain_run[1]:
        assert _syncs(info["trace"], "pgo") == 0
        assert "pin_slam.pgo" not in info["trace"]["span_ms"]
    # with PGO on, a tracked frame's descriptor uploads its pose
    assert _syncs(pgo_run[1][1]["trace"], "pgo") > 0


def test_stage_times_are_the_stage_spans(pgo_run, plain_run):
    for system, infos in (pgo_run, plain_run):
        assert len(system.stage_times) >= len(infos)
        for row, info in zip(system.stage_times, infos):
            spans = info["trace"]["span_ms"]
            assert row == [spans.get(f"pin_slam.{s}", 0.0) * 1e-3 for s in STAGES]
    # the back end has its own column, odometry and training theirs
    rows = np.asarray(pgo_run[0].stage_times)
    assert (rows[1:, [1, 2, 3, 4]] > 0.0).all()


def test_loop_verification_is_charged_to_pgo(pgo_run):
    system, infos = pgo_run
    closing = infos[CLOSE_AT]
    assert closing["loop_candidate"] == LOOP_TO and "loop_verified" in closing
    counts, spans = closing["trace"]["counts"], closing["trace"]["span_ms"]
    # verification's registration: at least one step and the final statistics
    assert counts["sync.pgo.gn_fetch"] >= 2
    assert spans["pin_slam.pgo.verify"] > 0.0 and spans["pin_slam.pgo.gn_step"] > 0.0
    assert spans["pin_slam.pgo.probe"] > 0.0
    # the frame's own registration ran before, under odometry, and only it
    assert counts["sync.odometry.gn_fetch"] == closing["reg_iters"] + 1
    for info in infos[:CLOSE_AT]:
        assert "sync.pgo.gn_fetch" not in info["trace"]["counts"]
        assert "pin_slam.pgo.gn_step" not in info["trace"]["span_ms"]


MAP_PARTS = ("sample", "insert", "local_map", "new_mask", "append_knn", "pool_append")
DEFORM_PARTS = ("adjust_map", "recreate_hash", "pool")


def test_map_update_parts(pgo_run, plain_run):
    for system, infos in (pgo_run, plain_run):
        for info in infos:
            spans = info["trace"]["span_ms"]
            parts = [spans[f"pin_slam.map_update.{p}"] for p in MAP_PARTS]
            assert all(ms > 0.0 for ms in parts)
            assert sum(parts) <= spans["pin_slam.map_update"]


def test_closure_deform_parts(pgo_run):
    system, infos = pgo_run
    closing = infos[CLOSE_AT]
    assert closing["pgo_applied"]
    spans = closing["trace"]["span_ms"]
    parts = [spans[f"pin_slam.pgo.deform.{p}"] for p in DEFORM_PARTS]
    assert all(ms > 0.0 for ms in parts)
    assert sum(parts) <= spans["pin_slam.pgo.deform"] <= spans["pin_slam.pgo"]
    # one pass over the pool rows a closure (the plain twin on the CPU)
    assert closing["trace"]["counts"]["pool.passes"] == 1
    assert "pool_pass" not in closing["trace"]["launches"]
    for info in infos[:CLOSE_AT]:
        assert not any(k.startswith("pin_slam.pgo.deform") for k in info["trace"]["span_ms"])
        assert "pool.passes" not in info["trace"]["counts"]


def test_frame_takes_over_only_the_dataset_stage():
    from pin_slam_torch.utils import tracing

    x = torch.arange(4)
    tracing.read(x.sum(), "outside", int)
    with tracing.span("pin_slam.vis.mesh"):
        tracing.read(x.sum(), "mesh_points", int)
    with tracing.span("pin_slam.dataset.preprocess"):
        assert tracing.read(x.sum(), "deskew", int) == 6
    with tracing.frame(3) as report:
        pass
    assert set(report["span_ms"]) == {"pin_slam.dataset.preprocess", "pin_slam.frame"}
    assert report["counts"] == {"sync.dataset.deskew": 1}
    assert set(report["wait_ms"]) == {"sync.dataset.deskew"}
    # what the frame took over is gone from the next one
    with tracing.frame(4) as after:
        pass
    assert set(after["span_ms"]) == {"pin_slam.frame"} and after["counts"] == {}


def _events_named(prof, prefix):
    return [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
            if ev.name.startswith(prefix)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_under_the_profiler(plain_run):
    from torch.profiler import ProfilerActivity, profile

    from pin_slam_torch.dataset.slam_dataset import Frame

    system, _ = plain_run
    arr, valid, n = _frames(4)[3]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        info = system.process_frame(Frame(arr, valid, n))
    ev = _events_named(prof, "pin_slam.")
    frames = [e for e in ev if e[0] == "pin_slam.frame"]
    assert len(frames) == 1
    for stage in ("upload", "odometry", "map_update", "training"):
        hits = [e for e in ev if e[0] == f"pin_slam.{stage}"]
        assert hits and all(_inside(e, frames[0]) for e in hits), stage
    odometry = [e for e in ev if e[0] == "pin_slam.odometry"]
    steps = [e for e in ev if e[0] == "pin_slam.odometry.gn_step"]
    assert len(steps) == info["reg_iters"]
    assert all(any(_inside(s, o) for o in odometry) for s in steps)


def test_span_enters_no_record_function_without_a_profiler(monkeypatch, plain_run):
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.utils import tracing

    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("pin_slam.odometry"):
        pass
    system, _ = plain_run
    arr, valid, n = _frames(5)[4]
    system.process_frame(Frame(arr, valid, n))
    assert entered == []
    # the same span opens one range while a profiler records
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with tracing.span("pin_slam.odometry"):
        pass
    assert entered == ["pin_slam.odometry"]


def test_read_upload_call_and_count():
    from pin_slam_torch.utils import tracing

    x = torch.arange(5)
    with tracing.frame(7) as report:
        with tracing.span("pin_slam.odometry"):
            assert tracing.read(x.sum(), "total", int) == 10
            assert torch.equal(tracing.read(x, "whole"), x)
            up = tracing.upload(np.ones(3), "ones", "cpu", torch.float32)
            assert up.dtype == torch.float32 and up.tolist() == [1.0, 1.0, 1.0]
            nz = tracing.call(torch.nonzero, "nonzero", x > 2)
            assert nz[:, 0].tolist() == [3, 4]
            bins = tracing.call(torch.bincount, "bincount", x, minlength=6, syncs=2)
            assert bins.tolist() == [1, 1, 1, 1, 1, 0]
            with tracing.part("gn_step"):
                assert tracing.read(x.max(), "top", int) == 4
        assert tracing.read(x.min(), "low", int) == 0
    assert report["frame_id"] == 7
    assert report["counts"] == {"sync.odometry.total": 1, "sync.odometry.whole": 1,
                                "sync.odometry.ones": 1, "sync.odometry.nonzero": 1,
                                "sync.odometry.bincount": 2, "sync.odometry.top": 1,
                                "sync.frame.low": 1}
    assert set(report["wait_ms"]) == set(report["counts"])
    assert set(report["span_ms"]) == {"pin_slam.frame", "pin_slam.odometry",
                                      "pin_slam.odometry.gn_step"}
    assert report["span_ms"]["pin_slam.odometry"] <= report["span_ms"]["pin_slam.frame"]


def _report(span_ms=None, counts=None, wait_ms=None):
    return {"frame_id": 0, "span_ms": span_ms or {}, "counts": counts or {},
            "wait_ms": wait_ms or {}, "launches": {}}


READINGS = {
    "host_syncs_per_frame": (10 + 4 + 31 + 1 + 3) / 2,
    "host_syncs_per_frame.odometry": (10 + 3) / 2,
    "sync_wait_ms.odometry": (2.5 + 1.0) / 2,
    "gn_iters_per_frame": (7 + 4) / 2,
    "host_busy_ms.training": ((20.0 - 1.5 - 4.0) + (12.0 - 0.5)) / 2,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_of_the_report(name):
    from slambench import harness

    read = harness.metric_reader(name)
    frames = [
        _report(span_ms={"pin_slam.training": 20.0, "pin_slam.odometry": 30.0},
                counts={"sync.odometry.gn_fetch": 10, "sync.training.check_index": 4,
                        "sync.stage": 5, "sync.pgo.gn_fetch": 31},
                wait_ms={"sync.odometry.gn_fetch": 2.5, "sync.training.check_index": 1.5,
                         "stage.training": 4.0, "stage.odometry": 9.0}),
        _report(span_ms={"pin_slam.training": 12.0},
                counts={"sync.pgo.descriptor": 1, "sync.odometry.origin": 3, "sync.stage": 5},
                wait_ms={"sync.odometry.origin": 1.0, "stage.training": 0.5,
                         "sync.pgo.descriptor": 3.0}),
    ]
    # a frame without the report (the parent's kind) counts in none of them
    run = harness.RunRecord(infos=[{"trace": frames[0], "reg_valid": True, "reg_iters": 7},
                                   {"trace": frames[1], "reg_valid": True, "reg_iters": 4},
                                   {"skipped": True}, {"reg_valid": True, "reg_iters": 100}])
    assert read(run) == pytest.approx(READINGS[name], rel=1e-12)
    assert read(harness.RunRecord(infos=[{"reg_valid": True, "reg_iters": 3}] * 3)) is None
    assert read(harness.RunRecord()) is None
