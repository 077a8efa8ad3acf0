"""Times of the row gather, the train and the eikonal kernel and the
training loop's row scatter at the main path's shapes, on seeded random
inputs, and of the append kNN's probe and ranking on the paths' own inputs,
for the port in this checkout or in another one.

    python3 scripts/kernel_ab.py [--root DIR] [--label NAME]
        [--kernels gather,train,eikonal,rank,scatter]

``--root`` names another checkout (for example an unpacked ``git archive``
of the parent commit): its ``pin_slam_torch`` is imported and its kernels are
built into its own ``build/kernels``, while the timers and the checks are
this checkout's ``chip_smoke.py``.  Running two checkouts in turns in one
call (A, B, B, A) compares two versions of the kernels on one card.

Prints one JSON line per shape, with ``ms`` (CUDA events around one launch
on an idle card: the host's launch path included) and ``device_ms``
(launches queued behind ``torch.cuda._sleep``: the device alone) of the
kernel, and of ``torch.index_select`` for the gathers; every gather is
checked bit-exact against ``table[idx]`` and every train and eikonal launch
against its plain version in float64.  The train kernel runs at B = 16384,
k = 6 in both modes (path A's and path B's shapes), and its general form at
path H's (per neighbour, VD 27) and pe_gaussian's (weighted_first, VD 35);
the eikonal kernel at n = 1638 of the same four.  The rank rows time
``mapper._probe_rank`` (whatever that checkout runs for the brick layout:
one fused kernel, or the torch brick gather followed by the rank kernel) on
the near and far inputs of the second frame of chip_smoke's paths A, B and
C, each checked exact against the torch brick gather followed by the plain
ranking, beside the bound; their ``kernels_ms`` is the device time of the
kernels and copies one call launches, summed from torch.profiler's device
events (the device time of a pipeline whose host syncs keep ``device_ms``
from hiding the host).  The scatter rows time the training loop's
per-iteration scatter step as that checkout's mapper makes it (the zero-base
``scatter_sum_rows``, or, in a checkout without it, ``torch.zeros`` and
``scatter_add_rows``) at path A's and B's shapes (N = 2^16+1 or 2^18+1 rows,
C = 9, M = 108132 indices on the first rows and a share on the sentinel row
N - 1, as on the paths), and the frame's plan build at (15, 108132), each as ``ms``,
``device_ms`` and ``kernels_ms``; the step's output is held to the float64
bound and printed as a sha256 digest, so that two checkouts' bits can be
compared.  Then the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, table rows, width, gathered rows): the training loop's feature
# gather and its pool-row gather at path A's and path B's capacities
GATHERS = [("A-feat", (1 << 16) + 1, 9, 98304), ("B-feat", (1 << 18) + 1, 9, 98304),
           ("A-pool", (1 << 21) + 1, 24, 245760), ("B-pool", (1 << 23) + 1, 42, 245760)]
# (label, weighted_first, VD): B = 16384 rows (train) and n = 16384 // 10 base
# rows (eikonal), k = 6, as on paths A and B (VD 3), and the general forms'
# shapes on path H (NeRF bands 4) and pe_gaussian (Gaussian 16 bands)
TRAINS = EIKONALS = [("A", True, 3), ("B", False, 3), ("H", False, 27),
                     ("pe_gaussian", True, 35)]
RANK_PATHS = ("A", "B", "C")
# (label, rows N, rows with terms, sentinel share): the training loop's
# feature table (local capacity + the sentinel row N - 1) at path A's and
# path B's capacities.  The terms fall on the local map's first rows, drawn
# here uniformly from the first R rows (in chip_smoke's captured iteration on
# an H100, 22,666 rows of path A and 15,121 of path B receive terms), and a
# share of them on the sentinel (there A 22,217 and B 8,690 of 108,132).
# M = B*k + n_grad*k destination indices an iteration, T iterations a
# frame, C = F + 1 columns.
SCATTERS = [("A", (1 << 16) + 1, 24576, 0.205), ("B", (1 << 18) + 1, 16384, 0.080)]
SCATTER_M, SCATTER_T, SCATTER_C = 108132, 15, 9


def rank_inputs(cs, path):
    """{"near": args, "far": args} of ``mapper._probe_rank`` in the second
    frame of chip_smoke's path (the local map reduced to its hash table)."""
    import types

    import torch

    from pin_slam_torch.slam import mapper as mp

    system, frames, _ = cs.make_path(path, 2)
    system.process_frame(frames[0])
    calls, orig = [], mp._probe_rank

    def grab(lm, *a):
        calls.append((types.SimpleNamespace(hash_rows=lm.hash_rows.clone()),)
                     + tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a))
        return orig(lm, *a)

    mp._probe_rank = grab
    try:
        system.process_frame(frames[1])
    finally:
        mp._probe_rank = orig
    return dict(zip(("near", "far"), calls[:2]))


def kernels_ms(fn, reps=20):
    """Device time of the kernels and copies one call of ``fn`` launches,
    summed over torch.profiler's device events (gaps between them left out):
    the mean of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False))
    return us / 1e3 / reps


def time_rank(cs, label):
    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops import _cuda, rank_kernel
    from pin_slam_torch.slam import mapper as mp

    for path in RANK_PATHS:
        for kind, args in rank_inputs(cs, path).items():
            lm, mc, tmpl, probe, q, k = args
            before = dict(_cuda.COUNTS)
            out = mp._probe_rank(*args)
            launched = {key: n - before.get(key, 0) for key, n in _cuda.COUNTS.items()
                        if n != before.get(key, 0)}
            ref = rank_kernel.probe_rank_plain(npts.brick_gather_fm(lm, mc, tmpl, probe),
                                               q.contiguous(), k, mc.local_capacity,
                                               mc.max_valid_dist2)
            torch.cuda.synchronize()
            cs.rank_check(out, ref, f"{path}-{kind}")
            t = cs.timings(lambda: mp._probe_rank(*args), None)
            G, n, Kc = q.shape[0], q.shape[1], tmpl.memb.shape[1]
            b, by, rows_fm_b, _ = cs.rank_brick_bounds(
                (lm.hash_rows, tmpl.bricks, tmpl.memb, probe, q, k, mc.local_capacity,
                 mc.max_valid_dist2, mc.voxel_size, mc.brick, mc.brick_rows))
            print(json.dumps({"checkout": label, "kernel": f"probe_rank[{path}-{kind}]",
                              "G": G, "n": n, "Kc": Kc, "k": k, "launches_per_call": launched,
                              "bound_ms": b, "bound_by": by, "rows_fm_bound_ms": rows_fm_b,
                              "ms": t["ms"], "device_ms": t["device_ms"],
                              "kernels_ms": kernels_ms(lambda: mp._probe_rank(*args)),
                              **{x: t[x] for x in t if x.startswith("device_ms_holds")}}),
                  flush=True)
        torch.cuda.empty_cache()


def time_scatter(cs, label):
    import hashlib

    import torch

    from pin_slam_torch.ops import _cuda, rows

    zero_base = hasattr(rows, "scatter_sum_rows")
    for name, N, R, share in SCATTERS:
        g = torch.Generator(device="cuda").manual_seed(7)
        L, M, C = N - 1, SCATTER_M, SCATTER_C
        idx = torch.randint(0, R, (SCATTER_T, M), generator=g, device="cuda")
        idx[torch.rand(SCATTER_T, M, generator=g, device="cuda") < share] = L
        val = torch.randn(M, C, generator=g, device="cuda")
        plans = rows.scatter_plans(idx, N)
        plan, idx0 = rows.plan_at(plans, 0), idx[0]
        if zero_base:
            step = lambda: rows.scatter_sum_rows(N, idx0, val, plan=plan, skip_row=L)
        else:
            step = lambda: rows.scatter_add_rows(torch.zeros(N, C, device="cuda"), idx0, val,
                                                 plan=plan, skip_row=L)
        before = dict(_cuda.COUNTS)
        out = step()
        launched = {key: n - before.get(key, 0) for key, n in _cuda.COUNTS.items()
                    if n != before.get(key, 0)}
        torch.cuda.synchronize()
        err, _ = cs.scatter_check(out, torch.zeros_like(out), idx0, val, L)
        b, by, tb = cs.scatter_bounds(N, C, idx0, L)
        t = cs.timings(step, None)
        plan_fn = lambda: rows.scatter_plans(idx, N)
        pt = cs.timings(plan_fn, None)
        print(json.dumps({
            "checkout": label, "kernel": f"scatter_step[{name}]", "N": N, "C": C, "M": M,
            "sentinel_terms": int((idx0 == L).sum()),
            "step": "scatter_sum_rows" if zero_base else "torch.zeros + scatter_add_rows",
            "launches_per_call": launched, "bound_ms": b, "bound_by": by,
            "table_bound_ms": tb, "ms": t["ms"], "device_ms": t["device_ms"],
            "kernels_ms": kernels_ms(step),
            **{x: t[x] for x in t if x.startswith("device_ms_holds")},
            "err_vs_f64": err,
            "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}), flush=True)
        print(json.dumps({
            "checkout": label, "kernel": f"scatter_plans[{name}]", "T": SCATTER_T, "M": M,
            "N": N, "dtype": str(plans.order.dtype), "ms": pt["ms"],
            "device_ms": pt["device_ms"], "kernels_ms": kernels_ms(plan_fn),
            **{x: pt[x] for x in pt if x.startswith("device_ms_holds")}}), flush=True)
        del idx, val, plans, plan, out
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", default="gather,train,eikonal,rank,scatter")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    from pin_slam_torch.ops import _cuda, rows
    from pin_slam_torch.ops import train_kernel as tk

    if os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(_cuda.__file__)))) != root:
        raise SystemExit(f"kernel_ab: imported pin_slam_torch from {_cuda.__file__}, not {root}")
    _cuda.build()
    label = args.label or root
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, N, C, M in GATHERS if "gather" in which else ():
        table = torch.randn(N, C, generator=g, device="cuda")
        idx = torch.randint(0, N, (M,), generator=g, device="cuda")
        out = rows.gather_rows(table, idx)
        torch.cuda.synchronize()
        cs.gather_check(out, table, idx, name)
        t = cs.timings(lambda: rows.gather_rows(table, idx, bounds_checked=True),
                       lambda: rows.gather_rows_plain(table, idx),
                       lambda: torch.index_select(table, 0, idx))
        b, _ = cs.bound(cs.nbytes(idx, out) + M * C * 4, 0)
        print(json.dumps({"checkout": label, "kernel": f"gather[{name}]", "N": N, "C": C,
                          "M": M, "bound_ms": b, **t}), flush=True)
        del table, idx, out
    for name, wf, vd in TRAINS if "train" in which else ():
        a = cs.synthetic_train_args(wf, 16384, 6, 1, vd=vd)
        out = tk.train_iter(*a)
        err, _ = cs._cmp(out, tk.train_iter_plain, a, f"train_iter {name}")
        t = cs.timings(lambda: tk.train_iter(*a), lambda: tk.train_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"train_iter[{name}]", "B": 16384,
                          "k": 6, "VD": vd, "weighted_first": wf, "max_abs_err_vs_plain": err,
                          **t}), flush=True)
    for name, wf, vd in EIKONALS if "eikonal" in which else ():
        a = cs.synthetic_eik_args(wf, 16384 // 10, 6, 2, vd=vd)
        out = tk.eikonal_iter(*a)
        err, _ = cs._cmp(out, tk.eikonal_iter_plain, a, f"eikonal {name}")
        t = cs.timings(lambda: tk.eikonal_iter(*a), lambda: tk.eikonal_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"eikonal[{name}]", "n": 16384 // 10,
                          "k": 6, "VD": vd, "weighted_first": wf, "max_abs_err_vs_plain": err,
                          **t}), flush=True)
    torch.cuda.empty_cache()
    if "rank" in which:
        time_rank(cs, label)
    if "scatter" in which:
        time_scatter(cs, label)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
