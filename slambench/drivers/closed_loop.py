"""The closed-loop frame driver: a sequence replayed as ``pin_slam.py``
replays one offline.

For each frame, ``SLAMDataset.preprocess_frame(i)``, then
``SlamSystem.process_frame``, then a synchronise; the next frame starts
when the last one is done.  The cell's ``warm_frames`` run first, as
set-up; the window then runs until ``--seconds`` have passed.  A traced
run (``--trace 1``) follows its window with ``cell["trace"]["frames"]``
frames under torch.profiler.

Every driver module has ``frames_needed(cell, seconds, trace)`` (the
frames the run asks the generator for) and ``run(...)``, which returns the
run's ``harness.RunRecord`` and what the check reads.
"""

from __future__ import annotations

import math
import time

import numpy as np

from slambench import harness
from slambench.harness import LAYER_PREFIX, Probes, RunRecord, log


def trace_frames(cell: dict) -> int:
    """Frames the traced run adds after its window: two to warm the
    profiler up, then the traced ones."""
    return 2 + int(cell["trace"]["frames"])


def frames_needed(cell: dict, seconds: float, trace: bool) -> int:
    """The cell's set-up frames, ``max_fps`` frames a second over the
    window, and with ``trace`` the traced frames."""
    n = int(cell["warm_frames"]) + int(math.ceil(float(cell["max_fps"]) * seconds))
    return n + (trace_frames(cell) if trace else 0)


def run(held, cell, cfg, seq, n_total, seconds, trace, dev, t_start, chips):
    """Set-up frames, then the measured window; returns the run's record and
    what the check reads (pose books, the map, closures) with the device's
    description."""
    import torch

    from slambench import reference as ref

    system, dataset = held["system"], held["dataset"]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    warm = int(cell["warm_frames"])
    rec = RunRecord()
    t_s = time.perf_counter()
    kept = []
    try:
        for i in range(min(warm, n_total)):
            frame = dataset.preprocess_frame(i)
            kept.append(int(frame.raw_count))
            system.process_frame(frame)
        sync()
    except Exception as e:      # the program failed in set-up: report it, judge what exists
        rec.error = harness.report(e)
        warm = n_total
    returns = [s.shape[0] for s in seq.scans]
    src = system.last_source
    log(f"set-up: {warm} frames in {time.perf_counter() - t_s:.2f} s; returns a sweep "
        f"mean / min / max {np.mean(returns):.0f} / {min(returns)} / {max(returns)}, after "
        f"the crop and cap (set-up frames' mean) {np.mean(kept or [0]):.0f}, the last set-up "
        f"frame's tracking source after its voxel step "
        f"{int(src[1].sum()) if src is not None else 0}")

    probes = Probes(system, cfg) if trace else None
    if probes is not None:
        probes.counting = True
    ate_frames = int(cell["ate_frames"])
    ate_poses = None
    n_stage0 = len(system.stage_times)
    i = warm
    t_w0 = time.perf_counter()
    rec.setup_s = t_w0 - t_start
    t_f1 = t_w0
    while True:
        if i >= n_total:
            rec.failed += 1                  # the sequence ran out: a shortfall
            break
        t_f0 = time.perf_counter()
        try:
            frame = dataset.preprocess_frame(i)
            t_d = time.perf_counter()
            info = system.process_frame(frame)
            sync()
        except Exception as e:  # the program failed: the frame and the run fail
            rec.error = harness.report(e)
            rec.failed += 1
            break
        t_f1 = time.perf_counter()
        rec.frame_s.append(t_f1 - t_f0)
        rec.dataset_s.append(t_d - t_f0)
        rec.infos.append(info)
        if info.get("reg_valid") is False:
            rec.failed += 1
        if i - warm + 1 == ate_frames:
            ate_poses = [p.copy() for p in harness.pose_books(system)[warm:warm + ate_frames]]
        i += 1
        if t_f1 - t_w0 >= seconds:
            break
    rec.window_s = t_f1 - t_w0
    rec.attempted = len(rec.frame_s)
    if ate_poses is not None:
        rec.ate_rmse_m = ref.ate_rmse(ate_poses, seq.gt_poses, warm)
    st = np.asarray(system.stage_times[n_stage0:], np.float64)
    rec.stage_s = st if st.size else None
    if probes is not None and rec.error is None:
        probes.counting = False
        rec.train_flops, rec.tracker_flops = probes.train_flops, probes.tracker_flops
        rec.trace = _traced_slice(system, dataset, probes, cell, i, n_total, sync, cuda)
        rec.traced_train_work = (probes.traced_flops, probes.traced_bytes)
    if probes is not None:
        probes.remove()

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    if trace and rec.trace:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
    out = {"device": device, "books": [p.copy() for p in harness.pose_books(system)],
           "snap": harness.snapshot(system, cfg),
           "closures": sum(1 for inf in rec.infos if inf.get("pgo_applied"))}

    def frames_with(key, value=True):
        return [warm + j for j, inf in enumerate(rec.infos) if inf.get(key) is value][:20]
    log(f"window: invalid registrations at frames {frames_with('reg_valid', False)}; loop "
        f"candidates at {[warm + j for j, inf in enumerate(rec.infos) if 'loop_candidate' in inf][:20]}, "
        f"z-rejected at {frames_with('loop_z_rejected')}, verified at "
        f"{frames_with('loop_verified')}, closed at {frames_with('pgo_applied')}")
    return rec, out


def _traced_slice(system, dataset, probes, cell, first, n_total, sync, cuda) -> dict:
    """The frames after the traced run's window, under torch.profiler: two
    to warm it up, then ``cell["trace"]["frames"]`` traced, each inside a
    ``slambench.frame`` span with the dataset's call in its own.  Returns
    ``devtrace.reduce_trace`` of them."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from slambench import devtrace

    n = int(cell["trace"]["frames"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, schedule=schedule(wait=0, warmup=2, active=n, repeat=1),
                   acc_events=True)
    prof.start()
    for k in range(min(trace_frames(cell), n_total - first)):
        probes.traced = k >= 2
        with record_function(devtrace.FRAME_SPAN):
            with record_function(LAYER_PREFIX + "dataset"):
                frame = dataset.preprocess_frame(first + k)
            system.process_frame(frame)
            sync()
        prof.step()
    probes.traced = False
    prof.stop()
    return devtrace.reduce_trace(prof.events(), Probes.LABELS, n)
