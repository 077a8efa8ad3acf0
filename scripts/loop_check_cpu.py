#!/usr/bin/env python3
"""Loop detection on path D's scene through both packages, on the CPU.

    python scripts/loop_check_cpu.py [--frames 96] [--n-az 256] [--n-el 32] [--out FILE]

Renders the square-loop scene of ``chip_smoke.py``'s path D (seed 7, rolling
128-beam sweeps, here thinned to ``n_az`` x ``n_el`` beams, a few thousand
points a sweep), writes it in the NCD-128 layout under a temporary
directory, and runs ``config/lidar_slam/run_ncd_128.yaml`` with path D's
overrides (pgo_freq 4, min_loop_travel_dist_ratio 1, reg_iter_n 100, the
valid-ratio gates 0.1 / 0.08) at small capacities through the JAX package's
``SlamSystem`` and then the port's (``device="cpu"``), each on its own.  On
every detection frame it records the local detector's and the global
(scan-context) detector's outputs, and per frame the loop candidate, its
verification and whether PGO was applied.  Prints one JSON line per
package and a summary: the detection frames, the best local distance and
the best global cosine distance seen, and the frames where the two
packages' detector outputs first part.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _config(Config, data_root, frames):
    from pin_slam_torch.dataset.indexing import set_dataset_path

    cfg = Config()
    cfg.load(os.path.join(ROOT, "config", "lidar_slam", "run_ncd_128.yaml"))
    cfg.pc_path = data_root
    set_dataset_path(cfg, "ncd128", "square")
    cfg.silence = True
    cfg.pgo_freq = 4
    cfg.min_loop_travel_dist_ratio = 1.0
    cfg.reg_iter_n = 100
    cfg.end_frame = frames
    cfg.map_capacity, cfg.local_map_capacity = 1 << 16, 1 << 14
    cfg.buffer_size, cfg.pool_capacity = 1 << 18, 1 << 19
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 17, 1 << 13, 1 << 11
    cfg._derive()
    return cfg


def _run(system, ld, frames):
    """Process ``frames`` frames, recording the detectors' outputs."""
    rec = {"local": {}, "global": {}}
    orig_local = ld.detect_local_loop
    orig_global = ld.NeuralPointMapContextManager.detect_global_loop

    def local(poses, travel, cur, drift, ratio, radius, *a, **kw):
        out = orig_local(poses, travel, cur, drift, ratio, radius, *a, **kw)
        # the nearest past pose the detector may take (past the travel gap)
        best = min((float(np.linalg.norm(poses[f][:3, 3] - poses[cur][:3, 3]))
                    for f in range(max(cur - 1, 0))
                    if travel[cur] - travel[f] >= ratio * radius), default=float("inf"))
        rec["local"][cur] = [int(out[0]), float(out[1]), best, float(drift)]
        return out

    def glob_(self, drift, travel, cur, *a, **kw):
        out = orig_global(self, drift, travel, cur, *a, **kw)
        rec["global"][cur] = [int(out[0]), float(out[1]), float(out[2])]
        return out

    ld.detect_local_loop = local
    ld.NeuralPointMapContextManager.detect_global_loop = glob_
    infos = []
    t0 = time.time()
    try:
        for i in range(frames):
            infos.append(system.process_frame(system.dataset.preprocess_frame(i)))
    finally:
        ld.detect_local_loop = orig_local
        ld.NeuralPointMapContextManager.detect_global_loop = orig_global
    gt = system.dataset.gt_poses[:frames, :3, 3]
    est = np.stack(system.dataset.pgo_poses)[:, :3, 3]
    return {"wall_s": time.time() - t0,
            "reg_valid": [bool(x.get("reg_valid", True)) for x in infos[1:]],
            "candidates": [(i, x["loop_candidate"], x.get("loop_verified"))
                           for i, x in enumerate(infos) if "loop_candidate" in x],
            "pgo_applied": [i for i, x in enumerate(infos) if x.get("pgo_applied")],
            "max_pos_err_m": float(np.linalg.norm(est - gt, axis=1).max()),
            "local": rec["local"], "global": rec["global"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--n-az", type=int, default=256)
    ap.add_argument("--n-el", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.slam import loop_detector as tld
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.slam import loop_detector as jld
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with tempfile.TemporaryDirectory() as tmp:
        scans, times, _, poses = syn.make_square_sweeps(np.random.default_rng(7),
                                                        n_az=args.n_az, n_el=args.n_el,
                                                        workers=4)
        syn.write_ncd_sequence(tmp, "square", scans, times, poses)
        out = {"scene": {"frames": args.frames, "beams": [args.n_az, args.n_el],
                         "points": [int(min(len(s) for s in scans)),
                                    int(max(len(s) for s in scans))]}}
        for name, Config, Slam, ld, kw in (("jax", JConfig, JSlam, jld, {}),
                                           ("torch", TConfig, TSlam, tld, {"device": "cpu"})):
            system = Slam(_config(Config, tmp, args.frames), **kw)
            system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
            system.tc_loop = dataclasses.replace(system.tc_loop, min_valid_ratio=0.08)
            out[name] = _run(system, ld, args.frames)
            print(json.dumps({name: out[name]}), flush=True)
    parted = {}
    for kind in ("local", "global"):
        j, t = out["jax"][kind], out["torch"][kind]
        frames = sorted(set(j) | set(t))
        first = next((f for f in frames if j.get(f, [None])[0] != t.get(f, [None])[0]), None)
        parted[kind] = first
    best_local = {k: min((v[2] for v in out[k]["local"].values()), default=None)
                  for k in ("jax", "torch")}
    best_global = {k: min((v[1] for v in out[k]["global"].values()), default=None)
                   for k in ("jax", "torch")}
    summary = {"detection_frames": sorted(int(f) for f in out["jax"]["local"]),
               "candidates": {k: out[k]["candidates"] for k in ("jax", "torch")},
               "pgo_applied": {k: out[k]["pgo_applied"] for k in ("jax", "torch")},
               "best_local_pose_distance_m": best_local,
               "best_global_cosine_distance": best_global,
               "first_frame_detector_outputs_part": parted,
               "max_pos_err_m": {k: out[k]["max_pos_err_m"] for k in ("jax", "torch")}}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out | {"summary": summary}, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
