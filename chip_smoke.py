#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pin_slam_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # what the checks run: build, three paths, kernel phases

1. Builds every CUDA kernel from ``pin_slam_torch/csrc`` (one nvcc per
   source, in parallel) into ``build/kernels``.
2. Path A: the default profile (weighted_first) at the bench capacities
   (map 2^18, local 2^16, pool 2^21, 2^15 rays/frame), 12 frames of the
   synthetic corridor world, PGO off.
3. Path B: ``config/lidar_slam/run_kitti.yaml`` (per-neighbour decoding,
   vox_down 0.08, 8 samples/ray) at the KITTI capacities (map 2^22,
   local 2^18, 2^17 rays, mapping bucket 2^16, pool 2^23), 8 frames, PGO off.
4. Path C: ``run_kitti.yaml`` as shipped (per-neighbour decoding, global
   scan-context loop detection) with PGO on, at path B's capacities, over
   every frame of the square-loop scene of the JAX package's loop-closure
   test (seed 7, side 8 m, step 0.8 m), with that test's overrides
   (pgo_freq 4, min_loop_travel_dist_ratio 1, reg_iter_n 100, valid-ratio
   gates 0.1 / 0.08).  It must add a loop factor, apply PGO, and keep the
   pose-graph trajectory within the test's gates (endpoint < 0.3 m and no
   worse than odometry + 0.5 m, position RMSE < 0.15 m).
   Each path runs with every kernel launch counter at 0 just before it and
   read just after; every kernel must have launched in it (the per-cell
   rank kernel must not: the brick layout probes and ranks in the fused
   ``rank_brick`` kernel, and never through its plain twin), losses must be
   finite, poses must stay near the scene's ground truth (A and B: every
   frame after the first must register).
5. Kernel phases: every kernel is run on the card on the inputs the paths
   gave it (captured in one extra, untimed frame after each path's timed
   frames, per path and shape), held against its plain PyTorch version
   (integers, ranks and gathers exact; floats part by part within the stated
   tolerances; the scatter, in its zero-base form that the path calls and
   in its table form, with the bits of the in-order sum
   ``rows.scatter_add_rows_ordered`` and within a float64 bound; the fused
   rank, the scatter, the train and the eikonal kernel also bit-identical
   across two launches) and timed beside its plain
   version and the one PyTorch call that computes the same function where
   there is one, each two ways:
   ``ms``, CUDA events around one launch on an idle card (median of 25; the
   host's launch path included), and ``device_ms``, many launches queued
   behind ``torch.cuda._sleep`` between two events (the device alone).  The
   train and eikonal kernels also at k = 8 on random inputs, the row kernels
   also at the Pallas experiment's own shape, the per-cell rank kernel
   (on no path) at path B's near shape with K = 81 on random rows.
6. Edge cases on random inputs: the train kernel at B in {1, 37, 16384}
   and the eikonal kernel at n in {1, 37, 1638}, each x k in {1, 6, 16} x
   both modes on dyadic inputs (float64 check, two launches bit-identical),
   the row gather at C in {1, 9, 24, 42} x M in {0, 1, 98304} on aligned
   and misaligned tables and on one of more than 2^31 floats (bit-exact),
   the fused rank kernel at G in {0, 1, 37} x n in {1, 4, 5} x k in
   {1, 6, 16} with both paths' candidate counts (Kc 64, 128) on a colliding
   random table, with negative probes and probes at 1e6, and the per-cell
   one at the same G, n, k with K 33 and 81 (exact, two launches
   bit-identical), both scatter forms at C in {1, 8, 9, 24} x N in
   {1, 33, 4099} x M in {0, 1, 5000}, with and without a skipped row (the
   in-order sum's bits, two launches bit-identical).

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, on any failure or without a GPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # float32 outside the tensor cores
TIMED = 25
DEVICE_REPS = 64                  # calls per device-time batch (fewer if the queue fills)
PLAIN_REPS = 8                    # the same for the plain versions (dozens of launches a call)
SLEEP_CYCLES_PER_S = 2.0e9        # above the H100's top SM clock: a sleep is never too short

# stated tolerances of the float comparisons on the card.  A training
# kernel's outputs are held, part by part, against its plain twin evaluated
# in float64 on the same inputs (T); each part has its own scale: the loss,
# the feature gradients dfeats[..., :F], the certainty column dfeats[..., F]
# (w, or the sum of the six stencil weights) and each decoder-gradient leaf
# (dW1, db1, dW2, db2).  A part passes if max|kernel - T| is within its
# tolerance times max|T| (TOL_REL; TOL_CERT for the certainty column).  A
# decoder leaf may instead be within DEC_ULPS float32 ulps (2^-23) of the
# largest |decoder gradient|: the leaves are batch sums of the same per-row
# output gradients, and where these cancel the leaf's own value is rounding
# noise of that size.  The eikonal's db2 is (nearly) zero in exact arithmetic (each
# central difference subtracts the output bias from itself); on an H100 its
# error measures up to about 5e-10 on path B against decoder gradients of
# about 1.2e-3, i.e. about 3 ulps of them.
TOL_REL = 1e-4
TOL_CERT = 1e-6
DEC_ULPS = 64
# the row scatter sums each destination row's n contributions in float32, in
# order: |sum - exact| <= n * 2^-24 * (|table| + sum |values|) (the standard
# bound for recursive summation, gamma_n ~ n u); each element is held to
# that bound against the float64 sum.
SCATTER_ULP = 2.0 ** -24


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: n/a"


# ----------------------------------------------------------------------
# capture of the kernels' inputs on the main path
# ----------------------------------------------------------------------


class Capture:
    """Wraps the main path's kernel wrappers.  While a path's timed frames run
    it only tallies launches per path and shape; while ``capturing`` (one
    extra, untimed frame after them) it keeps a clone of each kernel's inputs
    per path and shape instead.  It also counts calls of the fused rank
    kernel's plain twin, which the main path on the card must not make."""

    def __init__(self):
        from pin_slam_torch.ops import rank_kernel, rows, train_kernel

        self.rk, self.tk, self.rows = rank_kernel, train_kernel, rows
        self.orig = (rank_kernel.probe_rank_brick, train_kernel.train_iter,
                     train_kernel.eikonal_iter, rows.gather_rows, rows.scatter_sum_rows,
                     rank_kernel.probe_rank_brick_plain, rows.scatter_plans)
        self.path = None
        self.capturing = False
        self.inputs = {}
        self.tally = {}
        self.rank_calls = 0
        self.plain_rank_calls = 0

    def _keep(self, key, args, kwargs):
        import torch

        def clone(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            if isinstance(a, tuple) and hasattr(a, "_fields"):       # a ScatterPlan
                return type(a)(*(clone(x) for x in a))
            return a

        if self.capturing:
            self.inputs[key] = ([clone(a) for a in args],
                                {k: clone(v) for k, v in kwargs.items()})
        else:
            self.tally[key] = self.tally.get(key, 0) + 1

    def install(self):
        (probe_rank_brick, train_iter, eikonal_iter, gather_rows, scatter_sum_rows,
         rank_plain, scatter_plans) = self.orig

        def rank(*a, **kw):
            # every frame probes the shared endpoint balls first, then the
            # free-space samples (pipeline._frame_update -> append_knn)
            kind = "near" if self.rank_calls % 2 == 0 else "far"
            self.rank_calls += 1
            self._keep((self.path, "rank_brick", kind), a, kw)
            return probe_rank_brick(*a, **kw)

        def plain(*a, **kw):
            self.plain_rank_calls += 1
            return rank_plain(*a, **kw)

        def train(*a, **kw):
            self._keep((self.path, "train_iter", "main"), a, kw)
            return train_iter(*a, **kw)

        def eik(*a, **kw):
            self._keep((self.path, "eikonal", "main"), a, kw)
            return eikonal_iter(*a, **kw)

        def gather(*a, **kw):
            # the pool rows once per training call, the feature rows
            # (F + 1 = 9 columns) once per iteration
            self._keep((self.path, "gather", "feat" if a[0].shape[1] == 9 else "pool"), a, kw)
            return gather_rows(*a, **kw)

        def scatter(*a, **kw):
            # the training loop's scatter into a zero table, once per iteration
            self._keep((self.path, "scatter", "main"), a, kw)
            return scatter_sum_rows(*a, **kw)

        def plans(*a, **kw):
            # every iteration's scatter plan, once per training call
            self._keep((self.path, "plans", "frame"), a, kw)
            return scatter_plans(*a, **kw)

        (self.rk.probe_rank_brick, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_sum_rows, self.rk.probe_rank_brick_plain,
         self.rows.scatter_plans) = rank, train, eik, gather, scatter, plain, plans

    def uninstall(self):
        (self.rk.probe_rank_brick, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_sum_rows, self.rk.probe_rank_brick_plain,
         self.rows.scatter_plans) = self.orig


# ----------------------------------------------------------------------
# main-path runs
# ----------------------------------------------------------------------


# the main-path configurations: A and B are the JAX package's bench.py
# passes (PGO off); C is the loop-closure slice (run_kitti.yaml with PGO on)
PATHS = {
    "A": dict(profile=None, caps=(1 << 18, 1 << 16, 1 << 21, 1 << 21), n_rays=1 << 15,
              n_frames=12, mapping_bucket=0, dedup_budget=0.625),
    "B": dict(profile="config/lidar_slam/run_kitti.yaml",
              caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 17,
              n_frames=8, mapping_bucket=1 << 16, dedup_budget=0.5),
    "C": dict(profile="config/lidar_slam/run_kitti.yaml",
              caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 14,
              n_frames=None, mapping_bucket=0, dedup_budget=0.5, pgo=True),
}
# path C's overrides: those of the JAX package's square-loop test
# (tests/test_full_slam.py), which let a loop close on an 8 m square
SQUARE_SEED, SQUARE_PGO_FREQ = 7, 4


def make_path(name, n_frames=None):
    """(SlamSystem on the GPU, frames, ground-truth positions) of a path."""
    import torch

    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame, SLAMDataset
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    p = PATHS[name]
    n_rays = p["n_rays"]
    cfg = Config()
    if p["profile"]:
        cfg.load(os.path.join(ROOT, p["profile"]))
        cfg.pc_path = cfg.pose_path = cfg.calib_path = ""
    cfg.pgo_on = p.get("pgo", False)
    cfg.o3d_vis_on = False
    cfg.silence = True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity, cfg.buffer_size, cfg.pool_capacity = p["caps"]
    cfg.downsample_hash_size = max(1 << 19, cfg.buffer_size >> 2)
    cfg.frame_bucket = n_rays
    cfg.mapping_bucket = p["mapping_bucket"]
    cfg.probe_dedup_budget = p["dedup_budget"]
    dataset = None
    if cfg.pgo_on:
        cfg.pgo_freq = SQUARE_PGO_FREQ
        cfg.min_loop_travel_dist_ratio = 1.0
        cfg.reg_iter_n = 100
        cfg.kitti_correction_on = False    # the scene is synthetic, not KITTI's raw scans
    cfg._derive()

    if cfg.pgo_on:
        scans, gt_poses = syn.make_square_scene(np.random.default_rng(SQUARE_SEED))
        dataset = SLAMDataset(cfg, scans=scans, gt_poses=gt_poses)
        frames = [dataset.preprocess_frame(i) for i in range(len(scans))]
        gt = [T[:3, 3] for T in gt_poses]
    else:
        world = syn.make_world(np.random.default_rng(0))
        rng = np.random.default_rng(0)
        frames, gt = [], []
        for i in range(n_frames or p["n_frames"]):
            R, t = syn.sensor_pose(i)
            pts = syn.lidar_scan(rng, world, t, R, n_rays,
                                 n_az=1800 if n_rays > (1 << 16) else 900,
                                 n_el=128 if n_rays > (1 << 16) else 96)
            arr, valid = pad_to(pts, n_rays)
            frames.append(Frame(arr, valid, pts.shape[0]))
            gt.append(t)

    torch.cuda.reset_peak_memory_stats()
    system = SlamSystem(cfg, dataset=dataset, sync_stages=True)
    # synthetic dense-clutter scenes leave a smaller gate-passing fraction
    # than real LiDAR (the JAX package's bench and square-loop test make the
    # same adjustment)
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    system.tc_loop = dataclasses.replace(system.tc_loop, min_valid_ratio=0.08)
    return system, frames, gt


def _stage_ms(stage):
    keys = ("odometry", "map_update", "training", "pgo")
    if len(stage) == 0:
        return None
    return {k: float(stage[:, i + 1].mean() * 1e3) for i, k in enumerate(keys)}


def run_path(name, cap):
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp

    p = PATHS[name]
    pgo = p.get("pgo", False)
    if pgo:
        # every frame of the sequence is timed; the capture frame re-runs the last scan
        system, frames, gt = make_path(name)
        capture_frame = frames[-1]
    else:
        # the last frame is not timed: it only captures the kernels' inputs
        system, frames, gt = make_path(name, p["n_frames"] + 1)
        frames, capture_frame = frames[:-1], frames[-1]
    cfg = system.config
    n_rays, n_frames, mapping_bucket = p["n_rays"], len(frames), p["mapping_bucket"]
    cap.path = name
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    infos, times = [], []
    for fr in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos.append(system.process_frame(fr))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = dict(_cuda.COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ds = system.dataset
    poses = np.stack(ds.pgo_poses if pgo else ds.odom_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    if pgo:
        odom = np.stack(ds.odom_poses)
        end_err_odom = float(np.linalg.norm(odom[-1, :3, 3] - gt[len(odom) - 1]))
        loop_edges = [(e.i, e.j) for e in system.pgm.edges if abs(e.j - e.i) > 1]
        after_pgo = system.after_pgo
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_ref = time.perf_counter()
        mp.pool_refresh_cache(system.pool, system.state.attr_rows, system.mc)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t_ref) * 1e3
        refresh_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    cap.capturing = True
    system.process_frame(capture_frame)
    torch.cuda.synchronize()
    cap.capturing = False
    cap.path = None

    stage = np.asarray(system.stage_times[1:n_frames])
    res = {
        "phase": f"path_{name}", "profile": p["profile"] or "default (weighted_first)",
        "weighted_first": cfg.weighted_first, "frames": n_frames, "rays_per_frame": n_rays,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "pool": cfg.pool_capacity, "mapping_bucket": mapping_bucket},
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:])),
        "frame0_s": times[0],
        "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "reg_iters": [int(x.get("reg_iters", 0)) for x in infos[1:]],
        "max_pose_err_m": float(err.max()), "map_points": int(system.state.count),
        "local_points": int(system.lm.count), "pool_fill": int(system.pool.fill),
        "launches": counts,
        "max_memory_allocated_gb": peak_gb,
    }
    if pgo:
        closure = [i for i, x in enumerate(infos) if x.get("pgo_applied")]
        detect = [i for i in range(1, n_frames)
                  if i % cfg.pgo_freq == 0 and i not in closure]
        other = [i for i in range(1, n_frames) if i % cfg.pgo_freq != 0]
        st = np.asarray(system.stage_times[:n_frames])
        res.update({
            "stage_ms_mean": {"other_frames": _stage_ms(st[other]),
                              "detection_frames": _stage_ms(st[detect]),
                              "closure_frames": _stage_ms(st[closure])},
            "closure_frames": closure,
            "loop_candidates": [(i, x["loop_candidate"], x.get("loop_verified"))
                                for i, x in enumerate(infos) if "loop_candidate" in x],
            "loop_factors": loop_edges, "after_pgo": after_pgo,
            "end_err_pgo_m": float(err[-1]), "end_err_odom_m": end_err_odom,
            "rmse_pgo_m": float(np.sqrt(np.mean(err ** 2))),
            "pool_refresh_cache_ms": refresh_ms,
            "pool_refresh_cache_peak_gb": refresh_peak_gb,
            "pool_refresh_cache_chunk_rows": mp.REFRESH_CHUNK,
        })
    emit(res)
    if not all(x.get("loss_finite", False) for x in infos if "loss_finite" in x) \
            or not any("loss_finite" in x for x in infos):
        fail(f"path {name}: non-finite training loss")
    if res["map_points"] <= 0:
        fail(f"path {name}: empty map")
    if pgo:
        if not loop_edges:
            fail(f"path {name}: no loop factor was added")
        if not after_pgo:
            fail(f"path {name}: PGO never applied (after_pgo is False)")
        if not (res["end_err_pgo_m"] < 0.3 and res["end_err_pgo_m"] <= end_err_odom + 0.5):
            fail(f"path {name}: endpoint error {res['end_err_pgo_m']:.3f} m (odometry "
                 f"{end_err_odom:.3f} m)")
        if res["rmse_pgo_m"] >= 0.15:
            fail(f"path {name}: position RMSE {res['rmse_pgo_m']:.3f} m vs the ground truth")
        need = {k: 1 for k in counts if k != "rank"}
    else:
        if not all(res["reg_valid"]):
            fail(f"path {name}: a frame after the first did not register: {res['reg_valid']}")
        if res["max_pose_err_m"] > 0.5:
            fail(f"path {name}: pose error {res['max_pose_err_m']:.3f} m vs the scene's "
                 f"ground truth")
        iters = cfg.iters * (n_frames + cfg.init_iter_ratio - 1)
        need = {"rank_brick": n_frames, "train_iter": iters, "eikonal": iters,
                "gather": iters + n_frames, "scatter": iters}
    for k, n in need.items():
        if counts[k] < n:
            fail(f"path {name}: kernel {k} launched {counts[k]} times, expected >= {n}")
    # the brick layout probes and ranks in one kernel: no per-cell ranking,
    # no plain brick gather
    if counts["rank"] or cap.plain_rank_calls:
        fail(f"path {name}: the brick probe went through the per-cell rank kernel "
             f"({counts['rank']}) or the plain brick gather ({cap.plain_rank_calls})")
    del system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# kernel phases
# ----------------------------------------------------------------------


def time_ms(fn):
    """Event time of one call on an idle card (median of TIMED): the call's
    device time plus the host's launch path, which the card waits for."""
    import torch

    for _ in range(3):
        fn()
    ts = []
    for _ in range(TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def device_ms(fn, reps=DEVICE_REPS):
    """Device time of one call: ``reps`` calls queued behind ``torch.cuda._sleep``
    between two events, so the card runs them back to back and the host's
    launch path is hidden; ms / reps, the median of three batches.  The sleep
    lasts three times the host's wall time of ``reps`` synchronised calls.  A
    batch whose first event the card reached before the host had queued
    every call (the launch queue filled) is retried with half the calls.
    Returns (ms, hidden): ``hidden`` is False when even one call could not be
    queued ahead, i.e. the figure still holds host time (a call that waits
    on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(max((time.perf_counter() - t0) * reps * 3, 1e-3) * SLEEP_CYCLES_PER_S)
    ts, hidden = [], True
    while len(ts) < 3:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        early = a.query()
        b.synchronize()
        if early and reps > 1:
            reps //= 2
            continue
        hidden = hidden and not early
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts)), hidden


def timings(kernel, plain, library=None):
    """The row's event and device times of the kernel, its plain version and
    the library call (None where there is none)."""
    out, exposed = {}, []
    for key, fn, reps in (("", kernel, DEVICE_REPS), ("plain_", plain, PLAIN_REPS),
                          ("library_", library, DEVICE_REPS)):
        if fn is None:
            out[f"{key}ms"] = out[f"{key}device_ms"] = None
            continue
        out[f"{key}ms"] = time_ms(fn)
        out[f"{key}device_ms"], hidden = device_ms(fn, reps)
        if not hidden:
            exposed.append(key.rstrip("_") or "kernel")
    if exposed:
        out["device_ms_holds_host_time"] = exposed
    return out


def identical_check(a, b, label):
    """Fails unless two launches' outputs (a tensor or a tuple of them) are
    bit-identical."""
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    for i, (x, y) in enumerate(zip(a, b)):
        bits = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in (x, y)]
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(*bits):
            fail(f"{label}: two launches differ in output {i}")


def bound(nbytes, flops):
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rank_check(out_k, out_p, label):
    """Fails unless the rank kernel's (gidx, pos, valid) equal the plain
    version's exactly."""
    import torch

    for i, what in ((0, "gidx"), (2, "valid"), (1, "pos")):
        a, b = out_k[i], out_p[i].to(out_k[i].dtype)
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else -1
            fail(f"rank kernel {label}: {what} differs from the plain version ({bad} values)")


def rank_bound(G, n, K, k, cand_floats=None):
    """The ranking's least time: the candidate floats read once (by default
    the 5 K of each group's gathered field-major row), the queries and the
    outputs (17 bytes a neighbour); 9 operations per (query, candidate)."""
    cand = 5 * G * K if cand_floats is None else cand_floats
    return bound(4 * (cand + 3 * G * n) + G * n * k * 17, G * n * K * 9)


def rank_brick_bounds(args):
    """(bound_ms, bound_by, rows_fm_bound_ms, distinct rows) of the fused
    brick probe + rank on its inputs.  The function must read each distinct
    table row that its groups hash to once (neighbouring groups share bricks:
    their re-reads are cache traffic, not memory traffic), the probe points,
    the template and the queries, and write the outputs.  ``rows_fm_bound_ms``
    charges every group its own Kb rows instead, as the unfused pipeline's
    field-major rows held them: the rank rows' earlier bound, kept for
    comparison."""
    import torch

    from pin_slam_torch.ops.hash3d import grid_coords, spatial_hash

    _, bricks, memb, probe, queries, k, _, _, voxel, brick, Hb = args
    G, n = queries.shape[0], queries.shape[1]
    nsub, Kb = bricks.shape[0], bricks.shape[1]
    bvec = torch.tensor(brick, dtype=torch.int32, device=probe.device)
    gc = grid_coords(probe, voxel)
    bc = torch.div(gc, bvec, rounding_mode="floor")
    par = (gc - bc * bvec).long()
    bidx = (par[:, 0] * brick[1] + par[:, 1]) * brick[2] + par[:, 2]
    distinct = int(torch.unique(spatial_hash(bc[:, None, :] + bricks[bidx], Hb)).numel())
    fixed = 3 * G + bricks.numel() + memb.numel()
    b, by = rank_bound(G, n, Kb * nsub, k, 5 * nsub * distinct + fixed)
    rows_fm_b, _ = rank_bound(G, n, Kb * nsub, k, 5 * G * Kb * nsub + 3 * G)
    return b, by, rows_fm_b, distinct


def rank_brick_phase(label, args, launches):
    """The fused brick probe + rank on a captured input: exact against its
    plain version (the torch brick gather, then the plain ranking), two
    launches bit-identical, timed beside the plain version."""
    from pin_slam_torch.ops import rank_kernel as rk

    bricks, queries, k, Hb = args[1], args[4], args[5], args[10]
    G, n = queries.shape[0], queries.shape[1]
    Kb, nsub = bricks.shape[1], bricks.shape[0]
    Kc = Kb * nsub
    out_k = launched_twice(rk.probe_rank_brick, args, f"rank_brick kernel {label}")
    rank_check(out_k, rk.probe_rank_brick_plain(*args), label)
    t = timings(lambda: rk.probe_rank_brick(*args), lambda: rk.probe_rank_brick_plain(*args))
    b, by, rows_fm_b, distinct = rank_brick_bounds(args)
    row = {"name": f"rank_brick[{label}]", "route": "cuda",
           "source": "pin_slam_torch/csrc/rank.cu",
           "replaces": "pin_slam_tpu/ops/rank_kernel.py:105", "launches": launches,
           "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
           "rows_fm_bound_ms": rows_fm_b,
           "shape": {"G": G, "n": n, "Kb": Kb, "nsub": nsub, "Kc": Kc, "k": k, "Hb": Hb,
                     "distinct_rows": distinct},
           "check": "gidx/valid/pos exact against the plain version; two launches "
                    "bit-identical"}
    emit({"phase": "kernel", **row})
    return row


def rank_table(Hb, L, seed, brick=(2, 2, 1)):
    """A random brick-layout local hash: L points on a 1/8 m lattice in
    [-8, 8)^3, a tenth of them duplicated (exact distance ties), packed into
    Hb brick rows (many collisions).  Returns (MapConfig, table, points)."""
    import torch

    from pin_slam_torch.models import neural_points as npts

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.floor((torch.rand(L + 1, 3, generator=g, device="cuda") * 16 - 8) * 8) / 8
    pts[1:L // 10] = pts[L // 2:L // 2 + L // 10 - 1]
    mc = npts.MapConfig(capacity=1 << 20, local_capacity=L, hash_size=1 << 10,
                        voxel_size=0.4, feature_dim=8, nn_k=6, max_valid_dist2=1.0,
                        local_map_radius=10.0, travel_dist_window=50.0,
                        local_hash_size=Hb * brick[0] * brick[1] * brick[2], brick=brick)
    idx = torch.randint(0, 1 << 20, (L + 1,), generator=g, device="cuda")
    table = npts._pack_hash_rows(mc, pts, torch.tensor(L, device="cuda"), idx)
    return mc, table, pts


def rank_probes(pts, G, seed):
    """G probe points within 0.2 m of random map points; a quarter of them
    moved 20 m towards negative coordinates, off the map, and the last eighth
    at the dedup filler 1e6."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.randint(0, pts.shape[0] - 1, (G,), generator=g, device="cuda")
    probe = pts[pick] + (torch.rand(G, 3, generator=g, device="cuda") - 0.5) * 0.4
    probe[: G // 4] -= 20.0
    probe[G - G // 8:] = 1e6
    return probe


def rank_edge_phase():
    """The fused kernel at G in {0, 1, 37} x n in {1, 4, 5} x k in {1, 6, 16}
    on random tables with both paths' candidate counts (Kc 64 and 128: the
    default and run_kitti.yaml templates on a (2, 2, 1) brick), negative
    probes and probes at 1e6, and its scalar-load instantiation (on a table
    view 4 bytes off alignment, and on a (2, 1, 1) brick, whose 40-byte rows
    are no float4 rows) at G 37, n 1 / 5, k 6; the per-cell kernel at the
    same G, n, k as the first on random field-major rows with K 33 and 81.
    Each exact against its plain version and two launches bit-identical;
    G = 0 launches nothing.  Not a main-path shape, so kept out of the
    kernels line."""
    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import rank_kernel as rk

    cases = 0
    mc, table, pts = rank_table(4096, 4096, 0)
    for nei, alpha in ((2, 0.2), (2, 0.5)):
        tmpl = npts.make_probe_template(mc, nei, alpha, device="cuda")
        for G in (0, 1, 37):
            probe = rank_probes(pts, G, 10 + G)
            for n in (1, 4, 5):
                q = probe[:, None, :] + torch.linspace(-0.3, 0.3, n, device="cuda")[None, :, None]
                for k in (1, 6, 16):
                    args = (table, tmpl.bricks, tmpl.memb, probe, q, k, mc.local_capacity,
                            mc.max_valid_dist2, mc.voxel_size, mc.brick, mc.brick_rows)
                    label = f"edge G={G} n={n} k={k} Kc={tmpl.memb.shape[1]}"
                    before = _cuda.COUNTS["rank_brick"]
                    out = launched_twice(rk.probe_rank_brick, args, label)
                    if G == 0 and _cuda.COUNTS["rank_brick"] != before:
                        fail(f"rank_brick kernel {label}: launched at G = 0")
                    rank_check(out, rk.probe_rank_brick_plain(*args), label)
                    cases += 1
    off = torch.empty(table.numel() + 1, device="cuda")[1:].view_as(table)
    off.copy_(table)
    mc2, table2, pts2 = rank_table(4096, 4096, 1, brick=(2, 1, 1))
    for name, (m, tab, p) in {"off4": (mc, off, pts), "brick211": (mc2, table2, pts2)}.items():
        for nei, alpha in ((2, 0.2), (2, 0.5)):
            tmpl = npts.make_probe_template(m, nei, alpha, device="cuda")
            probe = rank_probes(p, 37, 5)
            for n in (1, 5):
                q = probe[:, None, :] + torch.linspace(-0.3, 0.3, n, device="cuda")[None, :, None]
                args = (tab, tmpl.bricks, tmpl.memb, probe, q, 6, m.local_capacity,
                        m.max_valid_dist2, m.voxel_size, m.brick, m.brick_rows)
                label = f"edge {name} n={n} Kc={tmpl.memb.shape[1]}"
                rank_check(launched_twice(rk.probe_rank_brick, args, label),
                           rk.probe_rank_brick_plain(*args), label)
                cases += 1
    for K in (33, 81):
        for G in (0, 1, 37):
            for n in (1, 4, 5):
                for k in (1, 6, 16):
                    rows, q = rank_cell_inputs(G, n, K, 4096, 20 + G + n)
                    args = (rows, q, k, 4096, 1.0)
                    label = f"per-cell edge G={G} n={n} k={k} K={K}"
                    out = launched_twice(rk.probe_rank, args, label)
                    rank_check(out, rk.probe_rank_plain(*args), label)
                    cases += 1
    emit({"phase": "rank_edges", "cases": cases,
          "check": "gidx/valid/pos exact against the plain version; two launches "
                   "bit-identical; no launch at G = 0"})


def rank_cell_inputs(G, n, K, L, seed):
    """Field-major candidate rows on a coarse lattice (exact distance ties),
    a share of invalid local indices, a quarter of the balls with at most 3
    valid candidates, and queries on the same lattice."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = lambda *s: torch.round((torch.rand(*s, generator=g, device="cuda") * 2 - 1) * 4) / 4
    lidx = torch.randint(0, L + L // 3, (G, 1, K), generator=g, device="cuda").float()
    lidx[: G // 4, :, 3:] = L
    gidx = torch.randint(0, 1 << 22, (G, 1, K), generator=g, device="cuda").float()
    rows = torch.cat([lat(G, 3, K), lidx, gidx], 1).reshape(G, 5 * K)
    return rows, lat(G, n, 3)


def rank_cells_phase():
    """The per-cell layout's rank kernel (no main path uses it; the brick
    layout is on in every path) on random field-major rows at path B's near
    shape with the per-cell template of run_kitti.yaml (K = 81): exact
    against its plain version, two launches bit-identical, timed.  Kept out
    of the kernels line."""
    from pin_slam_torch.ops import rank_kernel as rk

    G, n, K, k, L = 65536, 5, 81, 6, 1 << 18
    rows, q = rank_cell_inputs(G, n, K, L, 3)
    args = (rows, q, k, L, 1.0)
    out_k = launched_twice(rk.probe_rank, args, "rank kernel per-cell")
    rank_check(out_k, rk.probe_rank_plain(*args), "per-cell")
    t = timings(lambda: rk.probe_rank(*args), lambda: rk.probe_rank_plain(*args))
    b, by = rank_bound(G, n, K, k)
    emit({"phase": "rank_cells", "name": "rank[per-cell random]", "route": "cuda",
          "source": "pin_slam_torch/csrc/rank.cu",
          "replaces": "pin_slam_tpu/ops/rank_kernel.py:105", "launches": 0,
          "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
          "shape": {"G": G, "n": n, "K": K, "k": k},
          "check": "gidx/valid/pos exact; two launches bit-identical"})


def _parts(out):
    """(name, tensor, relative tolerance) of each separately scaled part of
    a training kernel's (loss, dfeats, dparams)."""
    from pin_slam_torch.ops import train_kernel as tk

    loss, dfeats, dparams = out
    F, IN, H = tk.KERNEL_F, tk.KERNEL_F + tk.KERNEL_VD, tk.KERNEL_H
    cuts = np.cumsum([0, IN * H, H, H, 1])
    leaves = [(n, dparams[a:b], TOL_REL, True) for n, a, b in
              zip(("dW1", "db1", "dW2", "db2"), cuts[:-1], cuts[1:])]
    return [("loss", loss.reshape(1), TOL_REL, False),
            ("dfeats", dfeats[..., :F], TOL_REL, False),
            ("certainty", dfeats[..., F], TOL_CERT, False)] + leaves


CHECK_TEXT = (f"vs the plain version in float64, each of loss, dfeats, certainty, dW1, db1, "
              f"dW2, db2 within {TOL_REL} x its max ({TOL_CERT} for certainty); a decoder "
              f"leaf also passes within {DEC_ULPS} ulps of the largest decoder gradient")


def _cmp(out_k, plain, args, label):
    """Holds a training kernel's outputs ``out_k`` against ``plain(*args)`` in
    float32 (P) and in float64 (T), part by part (see TOL_REL above).
    Returns (max |kernel - P| over the parts, {part: [|kernel - T|, |P - T|,
    max|T|]}); fails if a part is out of tolerance."""
    import torch

    out_p = plain(*args)
    out_t = plain(*[a.double() if isinstance(a, torch.Tensor) else a for a in args])
    dec_floor = DEC_ULPS * 2.0 ** -23 * float(out_t[2].abs().max())
    errs, detail = [], {}
    for (what, k, tol, dec), (_, p, _, _), (_, t, _, _) in zip(
            _parts(out_k), _parts(out_p), _parts(out_t)):
        e_k = float((k.double() - t).abs().max())
        e_p = float((p.double() - t).abs().max())
        scale = float(t.abs().max())
        detail[what] = [e_k, e_p, scale]
        if not (e_k <= tol * scale or (dec and e_k <= dec_floor)):
            fail(f"{label}: {what} max err {e_k:.3e} vs float64 (the plain version's own "
                 f"{e_p:.3e}) > {tol} x {scale:.3e}"
                 + (f" and > {dec_floor:.3e} ({DEC_ULPS} ulps of the largest decoder "
                    f"gradient)" if dec else ""))
        errs.append(float((k - p).abs().max()))
    return max(errs), detail


def decodes(wf, rows, k, per_row):
    return rows * per_row * (1 if wf else k)


def decode_flops():
    """Float32 operations one decode of a training kernel needs: the
    forward (IN x H FMAs, H bias adds, H FMAs into the output), dh (H), the
    input gradient of the F feature columns only (F x H FMAs: the offset
    vectors take none), and the decoder-gradient sums (IN x H + H FMAs,
    H adds)."""
    from pin_slam_torch.ops import train_kernel as tk

    F, IN, H = tk.KERNEL_F, tk.KERNEL_F + tk.KERNEL_VD, tk.KERNEL_H
    return (2 * IN * H + 3 * H) + H + 2 * F * H + (2 * IN * H + 3 * H)


def train_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import train_kernel as tk

    feats, w, vin, label_t, wt, params, wf, scale, sigma = args
    B, k = w.shape
    out_k = launched_twice(tk.train_iter, args, f"train_iter kernel {label}")
    err, detail = _cmp(out_k, tk.train_iter_plain, args, f"train_iter kernel {label}")
    t = timings(lambda: tk.train_iter(*args), lambda: tk.train_iter_plain(*args))
    flops = decodes(wf, B, k, decode_flops()) + (2 * B * k * tk.KERNEL_F if wf else 2 * B * k)
    b, by = bound(nbytes(feats, w, vin, label_t, wt, params, out_k[1], out_k[2]) + 4, flops)
    row = {"name": f"train_iter[{label}]", "route": "cuda",
           "source": "pin_slam_torch/csrc/train_iter.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:247", "launches": launches,
           "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
           "shape": {"B": B, "k": k, "weighted_first": wf},
           "launch": train_launch(B, k, wf, feats.get_device()),
           "check": CHECK_TEXT + "; two launches bit-identical", "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


def train_launch(B, k, wf, device):
    """The train kernel's launch at (B, k, mode) on ``device``: rows per
    block, blocks, threads per block, and the blocks per SM its registers
    allow."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    resident = tk.train_resident_blocks(device, bool(wf))
    R = tk.train_rows_per_block(B, k, bool(wf), resident)
    return {"rows_per_block": R, "blocks": -(-B // R), "threads": tk.TRAIN_THREADS,
            "blocks_per_sm": resident // _cuda.sm_count(device)}


def launched_twice(fn, args, label):
    """``fn(*args)`` twice; fails unless the two outputs are bit-identical.
    Returns the first."""
    import torch

    out1 = fn(*args)
    out2 = fn(*args)
    if out1[1].is_cuda:
        torch.cuda.synchronize()
    identical_check(out1, out2, label)
    return out1


def eik_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    feats, wst, vst, esc, params, wf, scale, step = args
    n, k = feats.shape[0], feats.shape[1]
    out_k = launched_twice(tk.eikonal_iter, args, f"eikonal kernel {label}")
    err, detail = _cmp(out_k, tk.eikonal_iter_plain, args, f"eikonal kernel {label}")
    t = timings(lambda: tk.eikonal_iter(*args), lambda: tk.eikonal_iter_plain(*args))
    flops = decodes(wf, n, k, 6 * decode_flops())
    b, by = bound(nbytes(feats, wst, vst, esc, params, out_k[1], out_k[2]) + 4, flops)
    R = tk.eikonal_rows_per_block(n, k, bool(wf), _cuda.sm_count(feats.get_device()))
    row = {"name": f"eikonal[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/eikonal.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:471", "launches": launches,
           "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
           "shape": {"n": n, "k": k, "weighted_first": wf},
           "launch": {"rows_per_block": R, "blocks": -(-n // R), "threads": 256},
           "check": CHECK_TEXT + "; two launches bit-identical", "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


def train_edge_phase():
    """The train kernel on dyadic inputs at B in {1, 37, 16384} x k in
    {1, 6, 16} x both modes: two launches bit-identical, and part by part
    against the plain version in float64 at the stated tolerances; at B = 0
    no launch and zero sums.  Not a main-path shape, so kept out of the
    kernels line."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    errs, cases = [], 0
    for wf in (True, False):
        for k in (1, 6, 16):
            args = synthetic_train_args(wf, 0, k, 0)
            before = _cuda.COUNTS["train_iter"]
            loss, dfeats, dparams = tk.train_iter(*args)
            if (_cuda.COUNTS["train_iter"] != before or dfeats.shape != (0, k, 9)
                    or float(loss) != 0.0 or bool(dparams.any())):
                fail(f"train_iter kernel edge B=0 k={k} wf={int(wf)}: launched, or not zero")
            cases += 1
            for B in (1, 37, 16384):
                label = f"train_iter kernel edge B={B} k={k} wf={int(wf)}"
                args = synthetic_train_args(wf, B, k, 200 + 10 * B + k, dyadic=True)
                err, _ = _cmp(launched_twice(tk.train_iter, args, label), tk.train_iter_plain,
                              args, label)
                errs.append(err)
                cases += 1
    emit({"phase": "train_edges", "cases": cases, "max_abs_err_vs_plain": max(errs),
          "check": CHECK_TEXT + "; two launches bit-identical"})


def eikonal_edge_phase():
    """The eikonal kernel on random inputs at n in {1, 37, 1638} x k in
    {1, 6, 16} x both modes: two launches bit-identical, and part by part
    against the plain version in float64 at the stated tolerances.  Not a
    main-path shape, so kept out of the kernels line."""
    from pin_slam_torch.ops import train_kernel as tk

    errs, cases = [], 0
    for wf in (True, False):
        for k in (1, 6, 16):
            for n in (1, 37, 1638):
                label = f"eikonal kernel edge n={n} k={k} wf={int(wf)}"
                args = synthetic_eik_args(wf, n, k, 100 + 10 * n + k, dyadic=True)
                err, _ = _cmp(launched_twice(tk.eikonal_iter, args, label),
                              tk.eikonal_iter_plain, args, label)
                errs.append(err)
                cases += 1
    emit({"phase": "eikonal_edges", "cases": cases, "max_abs_err_vs_plain": max(errs),
          "check": CHECK_TEXT + "; two launches bit-identical"})


def gather_edge_phase():
    """The row gather at C in {1, 9, 24, 42} x M in {0, 1, 98304}, on an
    aligned table and on views 4 and 8 bytes off alignment (the vector
    widths' fallbacks), and once on a table of more than 2^31 floats (64-bit
    offsets); each bit-exact against ``table[idx]``.  Kept out of the kernels
    line."""
    import torch

    from pin_slam_torch.ops import rows

    g = torch.Generator(device="cuda").manual_seed(11)
    N, cases = 65537, 0
    for C in (1, 9, 24, 42):
        buf = torch.randn(N * C + 2, generator=g, device="cuda")
        tables = {"aligned": buf[:N * C].view(N, C), "off4": buf[1:1 + N * C].view(N, C),
                  "off8": buf[2:2 + N * C].view(N, C)}
        for M in (0, 1, 98304):
            idx = torch.randint(0, N, (M,), generator=g, device="cuda")
            if M > 1:
                idx[:2] = torch.tensor([0, N - 1], device="cuda")
            for name, tab in tables.items():
                out = rows.gather_rows(tab, idx)
                torch.cuda.synchronize()
                gather_check(out, tab, idx, f"edge C={C} M={M} {name}")
                cases += 1
    C = 42
    N = (1 << 31) // C + 4096
    big = torch.randn(N, C, generator=g, device="cuda")
    idx = torch.randint(0, N, (98304,), generator=g, device="cuda")
    idx[:2] = torch.tensor([N - 1, N - 4096], device="cuda")
    out = rows.gather_rows(big, idx)
    torch.cuda.synchronize()
    gather_check(out, big, idx, f"edge C={C} N={N} (64-bit offsets)")
    del big, out
    torch.cuda.empty_cache()
    emit({"phase": "gather_edges", "cases": cases + 1, "check": "bit-exact against table[idx]"})


def gather_check(out, table, idx, label):
    """Fails unless a gather's result equals ``table[idx]`` bit for bit."""
    import torch

    from pin_slam_torch.ops import rows

    ref = rows.gather_rows_plain(table, idx)
    if out.shape != ref.shape or not torch.equal(out, ref):
        bad = int((out != ref).any(1).sum()) if out.shape == ref.shape else -1
        fail(f"gather kernel {label}: {bad} rows differ from table[idx]")


def gather_phase(label, args, kwargs, launches):
    """The row gather on a captured input: exact against ``table[idx]``;
    timed as the kernel alone (the wrapper's range check, one host sync, is
    done once per frame on the main path), the plain version and
    ``torch.index_select``."""
    import torch

    from pin_slam_torch.ops import rows

    table, idx = args[0], args[1]
    M, C = idx.shape[0], table.shape[1]
    out_k = rows.gather_rows(table, idx)
    torch.cuda.synchronize()
    gather_check(out_k, table, idx, label)
    t = timings(lambda: rows.gather_rows(table, idx, bounds_checked=True),
                lambda: rows.gather_rows_plain(table, idx),
                lambda: torch.index_select(table, 0, idx))
    b, by = bound(nbytes(idx, out_k) + M * C * 4, 0)
    row = {"name": f"gather[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:43", "launches": launches,
           "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
           "shape": {"N": table.shape[0], "C": C, "M": M,
                     "table_16B_aligned": table.data_ptr() % 16 == 0},
           "check": "bit-exact against table[idx]"}
    emit({"phase": "kernel", **row})
    return row


def scatter_check(out, table, idx, val, skip_row):
    """Holds a scatter's result against the float64 sum, element by element,
    to the recursive-summation bound (see SCATTER_ULP).  Returns the largest
    |error| and the largest error/bound ratio; fails past the bound."""
    import torch

    keep = idx != skip_row if skip_row is not None else torch.ones_like(idx, dtype=torch.bool)
    i, v = idx[keep], val[keep].double()
    exact = table.double().index_add(0, i, v)
    mag = table.double().abs().index_add(0, i, v.abs())
    n = torch.bincount(i, minlength=table.shape[0]).double()[:, None]
    err = (out.double() - exact).abs()
    lim = (n + 1.0) * SCATTER_ULP * mag
    ratio = float((err / torch.clamp(lim, min=1e-300)).max())
    if bool((err > lim).any()):
        bad = int((err > lim).any(1).sum())
        fail(f"scatter: {bad} rows beyond n * 2^-24 * sum|terms| of the float64 sum "
             f"(max err {float(err.max()):.3e})")
    return float(err.max()), ratio


def ordered_check(out, ref, label):
    """Fails unless a scatter's result has the bits of
    ``rows.scatter_add_rows_ordered`` (a sequential in-order index_add's)."""
    import torch

    a, b = (t.contiguous().view(torch.int32) for t in (out, ref))
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(a, b):
        bad = int((a != b).sum()) if out.shape == ref.shape else -1
        fail(f"scatter kernel {label}: {bad} elements differ from the in-order sum's bits")


def scatter_forms(n_rows, idx, val, plan, skip, table, label):
    """Both forms of the scatter kernel on one input, the zero-base form and
    the table form onto ``table``: each twice (bit-identical), each with the
    bits of ``scatter_add_rows_ordered`` and within the float64 bound.
    Returns (zero-base output, max error vs float64, max error/bound)."""
    import torch

    from pin_slam_torch.ops import rows

    zeros = torch.zeros_like(table)
    errs, ratios = [], []
    for form, base, fn in (
            ("zero-base", zeros,
             lambda: rows.scatter_sum_rows(n_rows, idx, val, plan=plan, skip_row=skip)),
            ("table", table,
             lambda: rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip))):
        out, again = fn(), fn()
        if out.is_cuda:
            torch.cuda.synchronize()
        identical_check(out, again, f"scatter kernel {form} {label}")
        ordered_check(out, rows.scatter_add_rows_ordered(base, idx, val, skip),
                      f"{form} {label}")
        err, ratio = scatter_check(out, base, idx, val, skip)
        errs.append(err)
        ratios.append(ratio)
        if form == "zero-base":
            out_z = out
    return out_z, max(errs), max(ratios)


def scatter_bounds(n_rows, C, idx, skip):
    """(bound_ms, bound_by, table_bound_ms) of a scatter.  The zero-base
    form must read the value rows that are not skipped and their entries of
    the int32 ``order``, the int32 offsets (N + 1), and write the (N, C)
    sums; one add per value element read.  ``table_bound_ms`` is the table
    form as the int64-plan kernel counted it: the table, the int64 indices
    and every value read, the table written, M * C adds."""
    M = idx.shape[0]
    m = M - (int((idx == skip).sum()) if skip is not None else 0)
    b, by = bound(4 * (m * C + m + n_rows + 1 + n_rows * C), m * C)
    tb, _ = bound(4 * (2 * n_rows * C + M * C) + 8 * M, M * C)
    return b, by, tb


def scatter_phase(label, n_rows, idx, val, plan, skip, launches, frame_idx=None):
    """The row scatter on one input: both forms checked (``scatter_forms``:
    the table form onto a seeded random table); timed, the zero-base form
    (the main path's call, plan given), the plain version and
    ``Tensor.index_add`` on a zero table, and the table form's kernel.  The
    plan is timed apart: one iteration's (``plan_ms``) and, where
    ``frame_idx`` holds a training call's (T, M) indices, the call's
    (``frame_plan_ms``, as the mapper builds it once a frame)."""
    import torch

    from pin_slam_torch.ops import rows

    N, C, M = n_rows, val.shape[1], idx.shape[0]
    if plan is None:
        plan = rows.scatter_plans(idx, N)
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(N, C, generator=g, device="cuda")
    zeros = torch.zeros_like(table)
    out_z, err64, ratio = scatter_forms(N, idx, val, plan, skip, table, label)
    out_p = rows.scatter_add_rows_plain(zeros, idx, val, skip)
    t = timings(lambda: rows.scatter_sum_rows(N, idx, val, plan=plan, skip_row=skip),
                lambda: rows.scatter_add_rows_plain(zeros, idx, val, skip),
                lambda: zeros.index_add(0, idx, val))
    tt = timings(lambda: rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip), None)
    b, by, tb = scatter_bounds(N, C, idx, skip)
    row = {"name": f"scatter[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:66", "launches": launches,
           "max_abs_err": float((out_z - out_p).abs().max()), **t,
           "bound_ms": b, "bound_by": by, "table_bound_ms": tb,
           "table_ms": tt["ms"], "table_device_ms": tt["device_ms"],
           "shape": {"N": N, "C": C, "M": M, "skip_row": skip,
                     "skip_row_terms": int((idx == skip).sum()) if skip is not None else 0,
                     "max_segment": int(torch.bincount(idx[idx != skip] if skip is not None
                                                       else idx, minlength=N).max())},
           "plan_ms": time_ms(lambda: rows.scatter_plans(idx, N)),
           "frame_plan_ms": (time_ms(lambda: rows.scatter_plans(frame_idx, N))
                             if frame_idx is not None else None),
           "frame_plan_shape": list(frame_idx.shape) if frame_idx is not None else None,
           "err_vs_f64": err64, "err_over_bound": ratio,
           "check": "zero-base and table forms each bit-identical to scatter_add_rows_ordered "
                    "(a sequential in-order index_add's bits) and across two launches; each "
                    "element within (n+1) * 2^-24 * (|base| + sum|terms|) of the float64 sum"}
    emit({"phase": "kernel", **row})
    return row


def scatter_edge_phase():
    """Both scatter forms at C in {1, 8, 9, 24} (the generic kernel, the
    experiment's and the main path's widths) x N in {1, 33, 4099} x M in
    {0, 1, 5000}, with and without a skipped row: a tenth of the indices on
    one row (a segment of ~500 terms, many rounds), another row fed
    only -0.0 terms (+0.0 in the zero-base form); each bit-identical to
    ``scatter_add_rows_ordered`` and across two launches.  Kept out of the
    kernels line."""
    import torch

    from pin_slam_torch.ops import rows

    g = torch.Generator(device="cuda").manual_seed(12)
    cases = 0
    for C in (1, 8, 9, 24):
        for N in (1, 33, 4099):
            for M in (0, 1, 5000):
                idx = torch.randint(0, N, (M,), generator=g, device="cuda")
                idx[torch.rand(M, generator=g, device="cuda") < 0.1] = N // 2
                val = torch.randn(M, C, generator=g, device="cuda")
                val[idx == N - 1] = -0.0
                table = torch.randn(N, C, generator=g, device="cuda")
                plan = rows.scatter_plans(idx, N)
                for skip in (None, N // 2):
                    scatter_forms(N, idx, val, plan, skip, table,
                                  f"edge C={C} N={N} M={M} skip={skip}")
                    cases += 1
    emit({"phase": "scatter_edges", "cases": cases,
          "check": "zero-base and table forms each bit-identical to scatter_add_rows_ordered "
                   "and across two launches"})


def experiment_shape_rows():
    """The row kernels at the Pallas experiment's own shape (table 65536 x 8,
    98304 random rows), checked and timed like the captured inputs; not a
    main-path shape, so these rows stay out of the kernels line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    L, F, M = 65536, 8, 98304
    tab = torch.randn(L, F, generator=g, device="cuda")
    idx = torch.randint(0, L, (M,), generator=g, device="cuda")
    val = torch.randn(M, F, generator=g, device="cuda")
    gather_phase("experiment", (tab, idx), {}, 0)
    scatter_phase("experiment", L, idx, val, None, None, 0)


def synthetic_train_args(wf, B, k, seed, device="cuda", dyadic=False):
    """Random inputs at the main path's widths (F=8, VD=3, H=64).
    ``dyadic``: as for ``synthetic_eik_args``, features, IDW weights, offset
    vectors and decoder are small integers over powers of two, so every
    hidden pre-activation is exact in float32."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    if dyadic:
        q = lambda lo, hi, den, *s: torch.randint(lo, hi + 1, s, generator=g,
                                                  device=device).float() / den
        params = torch.cat([q(-32, 32, 128, 11 * 64), q(-8, 8, 64, 64), q(-32, 32, 128, 64),
                            q(-8, 8, 64, 1)])
        return (q(-16, 16, 8, B, k, 9), q(1, 16, 64, B, k), q(-8, 8, 32, B, 3 if wf else 3 * k),
                r(B) * 0.3, u(B) / B, params, wf, 0.055, 0.1)
    w = u(B, k)
    w = w / w.sum(1, keepdim=True)
    params = torch.cat([r(11 * 64) * 0.3, r(64) * 0.1, r(64) * 0.3, r(1) * 0.1])
    return (r(B, k, 9), w, r(B, 3 if wf else 3 * k) * 0.2, r(B) * 0.3,
            u(B) / B, params, wf, 0.055, 0.1)


def synthetic_eik_args(wf, n, k, seed, device="cuda", dyadic=False):
    """Random eikonal inputs at the main path's widths.  ``dyadic``: the
    features, stencil weights, offset vectors and decoder are small integers
    over powers of two, so every hidden pre-activation is exact in float32.
    The float64 check then sees the kernel's own ReLU masks: at a million
    hidden units a random pre-activation within float32 rounding of 0 is
    likely, and its mask flip is a difference of the inputs' conditioning,
    not of the kernel."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    if dyadic:
        q = lambda lo, hi, den, *s: torch.randint(lo, hi + 1, s, generator=g,
                                                  device=device).float() / den
        params = torch.cat([q(-32, 32, 128, 11 * 64), q(-8, 8, 64, 64), q(-32, 32, 128, 64),
                            q(-8, 8, 64, 1)])
        return (q(-16, 16, 8, n, k, 9), q(1, 16, 64, 6 * n, k),
                q(-8, 8, 32, 6 * n, 3 if wf else 3 * k), u(n) * 0.5 / n, params, wf, 0.055, 0.08)
    wst = u(6 * n, k)
    wst = wst / wst.sum(1, keepdim=True)
    params = torch.cat([r(11 * 64) * 0.3, r(64) * 0.1, r(64) * 0.3, r(1) * 0.1])
    return (r(n, k, 9), wst, r(6 * n, 3 if wf else 3 * k) * 0.2, u(n) * 0.5 / n,
            params, wf, 0.055, 0.08)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pin_slam_torch")):
        print("chip_smoke: pin_slam_torch/ not found next to chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    from pin_slam_torch.ops import _cuda

    t0 = time.perf_counter()
    secs = _cuda.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": secs})

    cap = Capture()
    cap.install()
    try:
        results = {name: run_path(name, cap) for name in PATHS}
    finally:
        cap.uninstall()

    rows = []
    for path, res in results.items():
        for kind in ("far", "near"):
            key = (path, "rank_brick", kind)
            if key not in cap.inputs:
                fail(f"path {path}: no {kind} rank launch captured")
            rows.append(rank_brick_phase(f"path{path}-{kind}", cap.inputs[key][0],
                                         cap.tally[key]))
        a, kw = cap.inputs[(path, "train_iter", "main")]
        rows.append(train_phase(f"path{path}", a, kw, res["launches"]["train_iter"]))
        a, kw = cap.inputs[(path, "eikonal", "main")]
        rows.append(eik_phase(f"path{path}", a, kw, res["launches"]["eikonal"]))
        for kind in ("pool", "feat"):
            a, kw = cap.inputs[(path, "gather", kind)]
            rows.append(gather_phase(f"path{path}-{kind}", a, kw,
                                     cap.tally.get((path, "gather", kind), 0)))
        (n_rows, idx, val), kw = cap.inputs[(path, "scatter", "main")]
        (frame_idx, _), _ = cap.inputs[(path, "plans", "frame")]
        rows.append(scatter_phase(f"path{path}", n_rows, idx, val, kw.get("plan"),
                                  kw.get("skip_row"), res["launches"]["scatter"], frame_idx))
        for kernel, kinds in (("rank_brick", ("far", "near")), ("gather", ("pool", "feat")),
                              ("scatter", ("main",))):
            if sum(cap.tally.get((path, kernel, x), 0) for x in kinds) != res["launches"][kernel]:
                fail(f"path {path}: {kernel} launch tallies disagree with the counter")
    # k = 8 (which the JAX kernels cannot run): checked and timed on random
    # inputs at the main path's widths; not a main-path shape, so these rows
    # stay out of the kernels line
    for wf in (True, False):
        train_phase(f"k8-wf{int(wf)}", synthetic_train_args(wf, 16384, 8, 1), {}, 0)
        eik_phase(f"k8-wf{int(wf)}", synthetic_eik_args(wf, 1638, 8, 2), {}, 0)
    experiment_shape_rows()
    rank_cells_phase()
    rank_edge_phase()
    train_edge_phase()
    eikonal_edge_phase()
    gather_edge_phase()
    scatter_edge_phase()

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
