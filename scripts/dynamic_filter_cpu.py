#!/usr/bin/env python3
"""The dynamic filter on the labelled corridor through both packages, on the CPU.

    python scripts/dynamic_filter_cpu.py [--frames 16] [--points 8192] [--out FILE]

Renders ``pin_slam_torch.utils.synthetic``'s labelled corridor (seed 0, as
``chip_smoke.py``'s path F draws it, at a reduced size: ``--points`` a
sweep, 900 x 96 beams, density 1), writes it in the SemanticKITTI layout
under a temporary directory, and runs ``config/lidar_slam/run_kitti.yaml``
with path F's options (semantic_on, filter_moving_object, dynamic_filter_on,
estimate_normal) at small capacities through the JAX package's
``SlamSystem`` and then the port's (``device="cpu"``), each on its own.  On
every frame it evaluates the dynamic filter's keep mask on the frame's
points: the port's through ``SlamSystem.dynamic_static_mask``, the JAX
package's with its filter's own operations (``knn_search``,
``interpolate_features``, ``blended_sdf`` against the two thresholds,
``pipeline.py`` frame_update) on the local map and decoder it updated the
frame with, at the pose it selected.  Reports, pooled over the frames from
the car's entry (``CAR_ENTER``) on, the share of the car's points (learning
class 1) the filter drops and the share of the static surfaces' points
(road, building, pole) it keeps, and each frame's shares and position
error.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STATIC = (9, 13, 18)


def _config(Config, seq):
    cfg = Config()
    cfg.load(os.path.join(ROOT, "config", "lidar_slam", "run_kitti.yaml"))
    cfg.pc_path, cfg.label_path = f"{seq}/velodyne", f"{seq}/labels"
    cfg.pose_path, cfg.calib_path = f"{seq}/poses.txt", f"{seq}/calib.txt"
    cfg.semantic_on = cfg.filter_moving_object = True
    cfg.dynamic_filter_on = cfg.estimate_normal = True
    cfg.pgo_on, cfg.silence = False, True
    cfg.map_capacity, cfg.local_map_capacity = 1 << 16, 1 << 14
    cfg.buffer_size, cfg.pool_capacity = 1 << 18, 1 << 19
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 17, 1 << 13, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    cfg._derive()
    return cfg


def _shares(keep, frame, car_on):
    """(car points, car points dropped, static points, static points kept);
    the car's counted only from its entry on (``car_on``)."""
    v = np.asarray(frame.valid)
    lab = np.asarray(frame.sem_labels)
    car = v & (lab == 1) & car_on
    static = v & np.isin(lab, STATIC)
    return [int(car.sum()), int((car & ~keep).sum()), int(static.sum()),
            int((static & keep).sum())]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--points", type=int, default=1 << 13)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scans, labels, poses, _ = syn.labelled_corridor_scans(0, args.frames, args.points,
                                                              n_az=900, n_el=96)
        seq = syn.write_semantic_kitti_sequence(tmp, "00", scans, labels, poses,
                                                correction_deg=0.195)

        # the JAX package: its filter's operations on the state it updated with
        jsys = JSlam(_config(JConfig, seq))
        cfg, mc = jsys.config, jsys.mc
        offsets = jsys.offsets

        @jax.jit
        def jax_keep(lm, geo, points, R, t):
            pts_world = points @ R.T + t
            knn = jn.knn_search(lm, mc, pts_world, offsets)
            feat, _, w, cert = jn.interpolate_features(lm, mc, pts_world, knn.lidx)
            sdf_pred, _ = jdec.blended_sdf(geo, feat, w, mc.weighted_first, cfg.sdf_scale)
            return ((cert < cfg.dynamic_certainty_thre)
                    | (sdf_pred < cfg.dynamic_sdf_ratio_thre * cfg.voxel_size_m))

        rows, t0 = [], time.time()
        for i in range(args.frames):
            frame = jsys.dataset.preprocess_frame(i)
            lm = jax.tree.map(jnp.copy, jsys.lm)
            geo = jax.tree.map(jnp.copy, jsys.geo_params)
            jsys.process_frame(frame)
            T = jsys.cur_pose.astype(np.float32)
            keep = np.asarray(jax_keep(lm, geo, jnp.asarray(frame.points),
                                       jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3])))
            err = float(np.linalg.norm(jsys.cur_pose[:3, 3] - poses[i][:3, 3]))
            rows.append(_shares(keep, frame, i >= syn.CAR_ENTER) + [err])
        out["jax"] = {"rows": rows, "wall_s": time.time() - t0}

        # the port: its own filter, recorded where the pipeline calls it
        tsys = TSlam(_config(TConfig, seq), device="cpu")
        masks = {}
        orig = tsys.dynamic_static_mask

        def rec(points, R, t):
            keep = orig(points, R, t)
            masks[tsys.frame_id] = keep.cpu().numpy()
            return keep

        tsys.dynamic_static_mask = rec
        rows, t0 = [], time.time()
        for i in range(args.frames):
            frame = tsys.dataset.preprocess_frame(i)
            tsys.process_frame(frame)
            keep = masks.get(i, np.ones(frame.points.shape[0], bool))
            err = float(np.linalg.norm(tsys.cur_pose[:3, 3] - poses[i][:3, 3]))
            rows.append(_shares(keep, frame, i >= syn.CAR_ENTER) + [err])
        out["torch"] = {"rows": rows, "wall_s": time.time() - t0}

    summary = {"frames": args.frames, "points": args.points, "car_enter": syn.CAR_ENTER}
    for k in ("jax", "torch"):
        r = np.asarray(out[k]["rows"])
        summary[k] = {"car_points": int(r[:, 0].sum()),
                      "car_drop_share": float(r[:, 1].sum() / max(r[:, 0].sum(), 1)),
                      "static_keep_share": float(r[:, 3].sum() / max(r[:, 2].sum(), 1)),
                      "max_pos_err_m": float(r[:, 4].max()),
                      "per_frame_car_drop": [round(float(a[1] / a[0]), 4) if a[0] else None
                                             for a in r]}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out | {"summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
