"""Times of the row gather, the train and the eikonal kernel at the main
path's shapes, on seeded random inputs, and of the append kNN's probe and
ranking on the paths' own inputs, for the port in this checkout or in
another one.

    python3 scripts/kernel_ab.py [--root DIR] [--label NAME] [--kernels gather,train,eikonal,rank]

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
k = 6 in both modes (path A's and path B's shapes).  The rank rows time
``mapper._probe_rank`` (whatever that checkout runs for the brick layout:
one fused kernel, or the torch brick gather followed by the rank kernel) on
the near and far inputs of the second frame of chip_smoke's paths A, B and
C, each checked exact against the torch brick gather followed by the plain
ranking, beside the bound; their ``kernels_ms`` is the device time of the
kernels and copies one call launches, summed from torch.profiler's device
events (the device time of a pipeline whose host syncs keep ``device_ms``
from hiding the host).  Then the card's name and power limit.  Needs a CUDA
device.
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
# (label, weighted_first): B = 16384 rows (train) and n = 16384 // 10 base
# rows (eikonal), k = 6, as on both paths
TRAINS = EIKONALS = [("A", True), ("B", False)]
RANK_PATHS = ("A", "B", "C")


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", default="gather,train,eikonal,rank")
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
    for name, wf in TRAINS if "train" in which else ():
        a = cs.synthetic_train_args(wf, 16384, 6, 1)
        out = tk.train_iter(*a)
        err, _ = cs._cmp(out, tk.train_iter_plain, a, f"train_iter {name}")
        t = cs.timings(lambda: tk.train_iter(*a), lambda: tk.train_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"train_iter[{name}]", "B": 16384,
                          "k": 6, "weighted_first": wf, "max_abs_err_vs_plain": err, **t}),
              flush=True)
    for name, wf in EIKONALS if "eikonal" in which else ():
        a = cs.synthetic_eik_args(wf, 16384 // 10, 6, 2)
        out = tk.eikonal_iter(*a)
        err, _ = cs._cmp(out, tk.eikonal_iter_plain, a, f"eikonal {name}")
        t = cs.timings(lambda: tk.eikonal_iter(*a), lambda: tk.eikonal_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"eikonal[{name}]", "n": 16384 // 10,
                          "k": 6, "weighted_first": wf, "max_abs_err_vs_plain": err, **t}),
              flush=True)
    torch.cuda.empty_cache()
    if "rank" in which:
        time_rank(cs, label)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
