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
   read just after; every kernel must have launched in it, losses must be
   finite, poses must stay near the scene's ground truth (A and B: every
   frame after the first must register).
5. Kernel phases: every kernel is run on the card on the inputs the paths
   gave it (captured in one extra, untimed frame after each path's timed
   frames, per path and shape), held against its plain PyTorch version
   (integers and gathers exact; floats part by part within the stated
   tolerances; the scatter also bit-identical across two launches) and
   timed with CUDA events (median of 25 launches) beside the one PyTorch
   call that computes the same function where there is one; the train and
   eikonal kernels also at k = 8 on random inputs, the row kernels also at
   the Pallas experiment's own shape.

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
    """Wraps the five kernel wrappers.  While a path's timed frames run it
    only tallies launches per path and shape; while ``capturing`` (one extra,
    untimed frame after them) it keeps a clone of each kernel's inputs per
    path and shape instead."""

    def __init__(self):
        from pin_slam_torch.ops import rank_kernel, rows, train_kernel

        self.rk, self.tk, self.rows = rank_kernel, train_kernel, rows
        self.orig = (rank_kernel.probe_rank, train_kernel.train_iter,
                     train_kernel.eikonal_iter, rows.gather_rows, rows.scatter_add_rows)
        self.path = None
        self.capturing = False
        self.inputs = {}
        self.tally = {}
        self.rank_calls = 0

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
        probe_rank, train_iter, eikonal_iter, gather_rows, scatter_add_rows = self.orig

        def rank(*a, **kw):
            # every frame probes the shared endpoint balls first, then the
            # free-space samples (pipeline._frame_update -> append_knn)
            kind = "near" if self.rank_calls % 2 == 0 else "far"
            self.rank_calls += 1
            self._keep((self.path, "rank", kind), a, kw)
            return probe_rank(*a, **kw)

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
            self._keep((self.path, "scatter", "main"), a, kw)
            return scatter_add_rows(*a, **kw)

        (self.rk.probe_rank, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_add_rows) = rank, train, eik, gather, scatter

    def uninstall(self):
        (self.rk.probe_rank, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_add_rows) = self.orig


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
        need = {k: 1 for k in counts}
    else:
        if not all(res["reg_valid"]):
            fail(f"path {name}: a frame after the first did not register: {res['reg_valid']}")
        if res["max_pose_err_m"] > 0.5:
            fail(f"path {name}: pose error {res['max_pose_err_m']:.3f} m vs the scene's "
                 f"ground truth")
        iters = cfg.iters * (n_frames + cfg.init_iter_ratio - 1)
        need = {"rank": n_frames, "train_iter": iters, "eikonal": iters,
                "gather": iters + n_frames, "scatter": iters}
    for k, n in need.items():
        if counts[k] < n:
            fail(f"path {name}: kernel {k} launched {counts[k]} times, expected >= {n}")
    del system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# kernel phases
# ----------------------------------------------------------------------


def time_ms(fn):
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


def bound(nbytes, flops):
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rank_phase(label, args, launches):
    import torch

    from pin_slam_torch.ops import rank_kernel as rk

    rows_fm, queries, k, L, maxd2 = args
    G, n = queries.shape[0], queries.shape[1]
    K = rows_fm.shape[1] // 5
    out_k = rk.probe_rank(rows_fm, queries, k, L, maxd2)
    out_p = rk.probe_rank_plain(rows_fm, queries, k, L, maxd2)
    torch.cuda.synchronize()
    if not torch.equal(out_k[0], out_p[0].to(out_k[0].dtype)) or not torch.equal(out_k[2], out_p[2]):
        bad = (out_k[0] != out_p[0].to(out_k[0].dtype)).sum().item()
        fail(f"rank kernel {label}: integer outputs differ from the plain version ({bad} gidx)")
    err = float((out_k[1] - out_p[1]).abs().max())
    if err != 0.0:
        fail(f"rank kernel {label}: positions differ (max {err})")
    ms = time_ms(lambda: rk.probe_rank(rows_fm, queries, k, L, maxd2))
    plain = time_ms(lambda: rk.probe_rank_plain(rows_fm, queries, k, L, maxd2))
    b, by = bound(nbytes(rows_fm, queries, *out_k), G * n * K * 9)
    row = {"name": f"rank[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rank.cu",
           "replaces": "pin_slam_tpu/ops/rank_kernel.py:105", "launches": launches,
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
           "library_ms": None, "shape": {"G": G, "n": n, "K": K, "k": k},
           "check": "gidx/valid/pos exact"}
    emit({"phase": "kernel", **row})
    return row


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
            fail(f"{label}: {what} max err {e_k:.3e} vs float64 > {tol} x {scale:.3e}"
                 + (f" and > {dec_floor:.3e} ({DEC_ULPS} ulps of the largest decoder "
                    f"gradient)" if dec else ""))
        errs.append(float((k - p).abs().max()))
    return max(errs), detail


def decodes(wf, rows, k, per_row):
    return rows * per_row * (1 if wf else k)


def train_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import train_kernel as tk

    feats, w, vin, label_t, wt, params, wf, scale, sigma = args
    B, k = w.shape
    out_k = tk.train_iter(*args)
    err, detail = _cmp(out_k, tk.train_iter_plain, args, f"train_iter kernel {label}")
    ms = time_ms(lambda: tk.train_iter(*args))
    plain = time_ms(lambda: tk.train_iter_plain(*args))
    IN, H = tk.KERNEL_F + tk.KERNEL_VD, tk.KERNEL_H
    flops = decodes(wf, B, k, 6 * IN * H + 6 * H) + (2 * B * k * tk.KERNEL_F if wf else 2 * B * k)
    b, by = bound(nbytes(feats, w, vin, label_t, wt, params, out_k[1], out_k[2]) + 4, flops)
    row = {"name": f"train_iter[{label}]", "route": "cuda",
           "source": "pin_slam_torch/csrc/train_iter.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:247", "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
           "library_ms": None, "shape": {"B": B, "k": k, "weighted_first": wf},
           "check": CHECK_TEXT, "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


def eik_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import train_kernel as tk

    feats, wst, vst, esc, params, wf, scale, step = args
    n, k = feats.shape[0], feats.shape[1]
    out_k = tk.eikonal_iter(*args)
    err, detail = _cmp(out_k, tk.eikonal_iter_plain, args, f"eikonal kernel {label}")
    ms = time_ms(lambda: tk.eikonal_iter(*args))
    plain = time_ms(lambda: tk.eikonal_iter_plain(*args))
    IN, H = tk.KERNEL_F + tk.KERNEL_VD, tk.KERNEL_H
    flops = decodes(wf, n, k, 6 * (6 * IN * H + 6 * H))
    b, by = bound(nbytes(feats, wst, vst, esc, params, out_k[1], out_k[2]) + 4, flops)
    row = {"name": f"eikonal[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/eikonal.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:471", "launches": launches,
           "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
           "library_ms": None, "shape": {"n": n, "k": k, "weighted_first": wf},
           "check": CHECK_TEXT, "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


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
    ms = time_ms(lambda: rows.gather_rows(table, idx, bounds_checked=True))
    plain = time_ms(lambda: rows.gather_rows_plain(table, idx))
    lib = time_ms(lambda: torch.index_select(table, 0, idx))
    b, by = bound(nbytes(idx, out_k) + M * C * 4, 0)
    row = {"name": f"gather[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:43", "launches": launches,
           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
           "library_ms": lib, "shape": {"N": table.shape[0], "C": C, "M": M},
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


def scatter_phase(label, args, kwargs, launches):
    """The row scatter on a captured input: against the float64 sum (see
    SCATTER_ULP) and bit-identical across two launches; timed as the kernel
    alone (plan given, as on the main path), the plain version, and
    ``Tensor.index_add``.  The plan (sort + bincount) is timed apart."""
    import torch

    from pin_slam_torch.ops import rows

    table, idx, val = args[:3]
    plan, skip = kwargs.get("plan"), kwargs.get("skip_row")
    if plan is None:
        plan = rows.scatter_plans(idx, table.shape[0])
    N, C, M = table.shape[0], table.shape[1], idx.shape[0]
    out_k = rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip)
    out_k2 = rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_k2):
        fail(f"scatter kernel {label}: two launches differ")
    err64, ratio = scatter_check(out_k, table, idx, val, skip)
    out_p = rows.scatter_add_rows_plain(table, idx, val, skip)
    ms = time_ms(lambda: rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip))
    plain = time_ms(lambda: rows.scatter_add_rows_plain(table, idx, val, skip))
    lib = time_ms(lambda: table.index_add(0, idx, val))
    plan_ms = time_ms(lambda: rows.scatter_plans(idx, N))
    b, by = bound(nbytes(table, idx, val, out_k), M * C)
    row = {"name": f"scatter[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:66", "launches": launches,
           "max_abs_err": float((out_k - out_p).abs().max()), "ms": ms, "plain_ms": plain,
           "bound_ms": b, "bound_by": by, "library_ms": lib,
           "shape": {"N": N, "C": C, "M": M, "skip_row": skip,
                     "skip_row_terms": int((idx == skip).sum()) if skip is not None else 0},
           "plan_ms": plan_ms, "err_vs_f64": err64, "err_over_bound": ratio,
           "check": "bit-identical across two launches; each element within "
                    "(n+1) * 2^-24 * (|table| + sum|terms|) of the float64 sum"}
    emit({"phase": "kernel", **row})
    return row


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
    scatter_phase("experiment", (tab, idx, val), {}, 0)


def synthetic_train_args(wf, B, k, seed, device="cuda"):
    """Random inputs at the main path's widths (F=8, VD=3, H=64)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    w = u(B, k)
    w = w / w.sum(1, keepdim=True)
    params = torch.cat([r(11 * 64) * 0.3, r(64) * 0.1, r(64) * 0.3, r(1) * 0.1])
    return (r(B, k, 9), w, r(B, 3 if wf else 3 * k) * 0.2, r(B) * 0.3,
            u(B) / B, params, wf, 0.055, 0.1)


def synthetic_eik_args(wf, n, k, seed, device="cuda"):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
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
            key = (path, "rank", kind)
            if key not in cap.inputs:
                fail(f"path {path}: no {kind} rank launch captured")
            rows.append(rank_phase(f"path{path}-{kind}", cap.inputs[key][0], cap.tally[key]))
        a, kw = cap.inputs[(path, "train_iter", "main")]
        rows.append(train_phase(f"path{path}", a, kw, res["launches"]["train_iter"]))
        a, kw = cap.inputs[(path, "eikonal", "main")]
        rows.append(eik_phase(f"path{path}", a, kw, res["launches"]["eikonal"]))
        for kind in ("pool", "feat"):
            a, kw = cap.inputs[(path, "gather", kind)]
            rows.append(gather_phase(f"path{path}-{kind}", a, kw,
                                     cap.tally.get((path, "gather", kind), 0)))
        a, kw = cap.inputs[(path, "scatter", "main")]
        rows.append(scatter_phase(f"path{path}", a, kw, res["launches"]["scatter"]))
        for kernel, kinds in (("rank", ("far", "near")), ("gather", ("pool", "feat")),
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

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
