"""The port's deskew and bundle adjustment (BA) against the benchmark's plain
reference (``slambench/reference_deskew_ba.py``) at full size, on the card:
the ``ncd_os0_128.quad`` cell run as ``slambench/run.py --trace 1`` runs it
(set-up, the 45 s window, the traced frames), with the inputs of some of
its deskews and BA calls captured as the program makes them.

    python3 scripts/ncd_reference_check.py --seed N [--seconds 45]
        [--deskew-frames 30,150,190] [--ba-calls 2] [--out FILE]

- Deskew: for each frame named, the points, times and motion the dataset
  hands ``deskew_points`` and what it returns, against the reference's
  deskew of the same inputs in float64.  Beside the port's error it prints
  those of a deskew in float16 (the inputs and the result rounded to half
  precision) and of one that drops the slerp (translation alone): the
  tolerance must fail both.
- BA: the first iteration of each of the first ``--ba-calls`` calls in the
  window, on its captured inputs (the pool rows of the batch, the pose
  window, the local map, its features and the frozen decoder): the loss
  and both gradients (in the features and in the window's corrections)
  against the reference's, at the samples where the program's hash probe
  picks the same neighbours as exact kNN and that lie more than 1 mm from
  every neighbour; the shares of valid samples whose neighbours differ, and
  of those on top of a neural point, are printed too.  Beside the port's
  errors it prints the reference's own at inputs rounded to float16: the
  tolerances must fail them.

Prints one JSON line (also written to ``--out``): the run's readings and
checks, every BA call's loss and pose shift, and the comparisons with their
tolerances and whether each holds.  Exits 1 when one does not.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# deskew: float32 arithmetic on points up to 50 m rounds at ~5e-6 m; a
# float16 deskew errs by ~1e-2 m there and a dropped slerp by the sweep's
# rotation times the range (~1e-1 m): 1e-4 m lies between
DESKEW_TOL_M = 1e-4
# BA, float32 against float64: the loss to 1e-5 of itself, each gradient to
# 1e-4 of its largest entry (float16 inputs move both by ~1e-3)
BA_LOSS_RTOL = 1e-5
BA_GRAD_RTOL = 1e-4


def _deskew_errors(rd, pts, ts, motion, out):
    import torch

    F64 = torch.float64
    ref = rd.deskew(pts, ts, motion)
    half = rd.deskew(pts.half(), ts.half(), motion.half()).half().to(F64)
    u = (ts.to(F64) - ts.min()) / (ts.max() - ts.min()) - 0.5
    no_slerp = pts.to(F64) + u[:, None] * motion.to(F64)[:3, 3][None, :]

    def err(x):
        return float(torch.linalg.norm(x.to(F64) - ref, dim=1).max())
    return {"points": int(pts.shape[0]), "err_max_m": err(out),
            "moved_max_m": float(torch.linalg.norm(ref - pts.to(F64), dim=1).max()),
            "float16_err_max_m": err(half), "no_slerp_err_max_m": err(no_slerp),
            "tol_m": DESKEW_TOL_M,
            "ok": err(out) <= DESKEW_TOL_M < min(err(half), err(no_slerp))}


def ba_snapshot(lm, mc, mcfg, feats, decoder):
    """The local map as the reference reads it: its neural points (the rows
    past its count out of reach), the features ``feats`` and the decoder,
    in float64, offsets in each point's own frame."""
    import torch

    from slambench import reference as ref

    F64 = torch.float64
    pos = lm.attr_rows[:, 0:3].to(F64).clone()
    pos[int(lm.count):] = float("inf")
    return ref.MapSnapshot(
        positions=pos, quats=lm.attr_rows[:, 3:7].to(F64), features=feats.to(F64),
        layers=[(W.detach().to(F64), None if b is None else b.detach().to(F64))
                for W, b in decoder.layers()],
        nn_k=int(mc.nn_k), max_valid_dist2=float(mc.max_valid_dist2), idw_eps=float(mc.idw_eps),
        sdf_scale=float(mcfg.sdf_scale), rotate_offsets=True)


def ba_samples(lm, mc, mcfg, feats, decoder, pool, offsets, poses_full, window_start, xi, idx):
    """The pool rows ``idx`` as BA reads them, and which of them both sides
    compare: a dict of the reference's map (``snap``), ``local``, ``ts``,
    ``valid`` (in the pool, a surface sample, a booked frame), ``exact``
    (the exact kNN neighbours), ``same`` (the port's hash probe picks the
    same ones) and ``on_point`` (within 1 mm of a neighbour); ``compared``
    is valid, same and not on a point."""
    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.slam import mapper as mp
    from slambench import reference_deskew_ba as rd

    F64 = torch.float64
    rows = pool.rows[idx]
    ts = rows[:, mp.P_TS].to(torch.int64)
    valid = (idx < pool.fill) & (torch.abs(rows[:, mp.P_LABEL]) < 1e-6) & (rows[:, mp.P_TS] >= 0)
    local = rows[:, mp.P_LOCAL]
    snap = ba_snapshot(lm, mc, mcfg, feats, decoder)
    world = rd.ba_world_points(poses_full, window_start, xi.to(F64), local, ts)
    exact = rd.exact_neighbours(snap.positions, world, snap.nn_k, snap.max_valid_dist2)
    port = npts.knn_search(lm, mc, world.float(), offsets).lidx
    port = torch.where(port < mc.local_capacity, port, torch.full_like(port, -1))
    same = rd.same_neighbours(port, exact)
    # a sample within 1 mm of a neural point (the pool's surface samples hold
    # the measured points, and each neural point is one of them): its weight
    # 1 / (d^2 + 1e-15) and that weight's gradient rest on d^2's float32
    # rounding there, so it is left out of the comparison and counted
    d2 = torch.sum((world[:, None, :] - snap.positions[exact.clamp(min=0)]) ** 2, -1)
    on_point = torch.where(exact >= 0, d2, torch.full_like(d2, float("inf"))).amin(1) < 1e-6
    return {"snap": snap, "local": local, "ts": ts, "valid": valid, "exact": exact,
            "same": same, "on_point": on_point, "compared": valid & same & ~on_point}


def _ba_compare(rd, ref, mp, lm, mc, feats, decoder, pool, mcfg, offsets, poses_full,
                window_start, xi, idx):
    """The first iteration of a BA call: the port's ``ba_value_and_grad``
    against the reference's, where both pick the same neighbours."""
    import torch

    F64 = torch.float64
    b = ba_samples(lm, mc, mcfg, feats, decoder, pool, offsets, poses_full, window_start, xi,
                   idx)
    snap, local, ts, valid, exact = b["snap"], b["local"], b["ts"], b["valid"], b["exact"]
    same, on_point, both = b["same"], b["on_point"], b["compared"]
    loss, g_f, g_x = mp.ba_value_and_grad(lm, mc, mcfg, offsets, decoder, feats, xi, poses_full,
                                          window_start, local, ts, both)
    r_loss, r_f, r_x, _ = rd.ba_loss_and_grads(snap, poses_full, window_start, xi, local, ts,
                                               both, exact)
    half = ref.MapSnapshot(**{**snap.__dict__, "features": snap.features.half().to(F64),
                              "positions": snap.positions.half().to(F64)})
    h_loss, h_f, h_x, _ = rd.ba_loss_and_grads(half, poses_full, window_start, xi,
                                               local.half().to(F64), ts, both, exact)

    def rel(a, b):
        return float(torch.abs(a.to(F64) - b).max() / torch.abs(b).max())
    out = {"samples": int(idx.shape[0]), "valid": int(valid.sum()), "compared": int(both.sum()),
           "neighbours_differ_share": float((valid & ~same).sum() / valid.sum().clamp(min=1)),
           "on_point_share": float((valid & on_point).sum() / valid.sum().clamp(min=1)),
           "window": int(xi.shape[0]), "window_start": int(window_start),
           "loss": float(r_loss), "loss_rel_err": abs(float(loss) - float(r_loss)) / float(r_loss),
           "g_features_rel_err": rel(g_f, r_f), "g_xi_rel_err": rel(g_x, r_x),
           "float16": {"loss_rel_err": abs(float(h_loss) - float(r_loss)) / float(r_loss),
                       "g_features_rel_err": rel(h_f, r_f), "g_xi_rel_err": rel(h_x, r_x)},
           "tol": {"loss_rel": BA_LOSS_RTOL, "grad_rel": BA_GRAD_RTOL}}
    out["ok"] = (out["loss_rel_err"] <= BA_LOSS_RTOL and out["g_features_rel_err"] <= BA_GRAD_RTOL
                 and out["g_xi_rel_err"] <= BA_GRAD_RTOL
                 and out["float16"]["loss_rel_err"] > BA_LOSS_RTOL
                 and min(out["float16"]["g_features_rel_err"],
                         out["float16"]["g_xi_rel_err"]) > BA_GRAD_RTOL)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--deskew-frames", default="30,150,190")
    ap.add_argument("--ba-calls", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slambench.run import set_cache_dirs

    set_cache_dirs(ROOT)
    import torch

    from pin_slam_torch.dataset import slam_dataset
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.pipeline import SlamSystem
    from slambench import harness
    from slambench import reference as ref
    from slambench import reference_deskew_ba as rd

    if not torch.cuda.is_available():
        print("ncd_reference_check: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    want = {int(f) for f in args.deskew_frames.split(",") if f}
    deskews, bas, ba_infos = [], [], []
    calls = {"deskew": 0, "ba": 0}
    orig_deskew, orig_loop = slam_dataset.deskew_points, mp.bundle_adjustment_loop
    orig_ba = SlamSystem._bundle_adjustment

    def deskew(points, ts, motion, *a, **kw):
        out = orig_deskew(points, ts, motion, *a, **kw)
        calls["deskew"] += 1                     # frame 0 is not deskewed
        if calls["deskew"] in want:
            d = _deskew_errors(rd, points, ts, motion, out)
            deskews.append({"frame": calls["deskew"], **d})
        return out

    def loop(lm, mc, feats, decoder, pool, mcfg, offsets, poses_full, window_start, xi,
             batch_idx, *a, **kw):
        calls["ba"] += 1
        if calls["ba"] <= args.ba_calls:
            bas.append(_ba_compare(rd, ref, mp, lm, mc, feats.contiguous(), decoder, pool, mcfg,
                                   offsets, poses_full, window_start, xi, batch_idx[0]))
        return orig_loop(lm, mc, feats, decoder, pool, mcfg, offsets, poses_full, window_start,
                         xi, batch_idx, *a, **kw)

    def bundle_adjustment(self):
        out = orig_ba(self)
        if out is not None:
            ba_infos.append({"frame": self.frame_id, **{k: out[k] for k in (
                "window", "loss_first", "loss_last", "mean_pose_shift_m", "ms")}})
        return out

    slam_dataset.deskew_points, mp.bundle_adjustment_loop = deskew, loop
    SlamSystem._bundle_adjustment = bundle_adjustment
    try:
        spec = harness.load_cell("ncd_os0_128.quad", ROOT)
        res = harness.run_cell(spec, args.seed, args.seconds, True, "cuda:0",
                               time.perf_counter())
    finally:
        slam_dataset.deskew_points, mp.bundle_adjustment_loop = orig_deskew, orig_loop
        SlamSystem._bundle_adjustment = orig_ba
    ok = bool(deskews) and bool(bas) and all(d["ok"] for d in deskews + bas)
    line = {"seed": args.seed, "ok": ok, "correct": res["correct"], "checks": res["checks"],
            "readings": res["readings"], "metrics": res["metrics"], "deskew": deskews,
            "ba": bas, "ba_calls": ba_infos}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
