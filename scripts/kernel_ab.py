"""Times of the row gather, the train and the eikonal kernel at the main
path's shapes, on seeded random inputs, for the port in this checkout or in
another one.

    python3 scripts/kernel_ab.py [--root DIR] [--label NAME]

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
k = 6 in both modes (path A's and path B's shapes).  Then the card's name
and power limit.  Needs a CUDA device.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
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
    for name, N, C, M in GATHERS:
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
    for name, wf in TRAINS:
        a = cs.synthetic_train_args(wf, 16384, 6, 1)
        out = tk.train_iter(*a)
        err, _ = cs._cmp(out, tk.train_iter_plain, a, f"train_iter {name}")
        t = cs.timings(lambda: tk.train_iter(*a), lambda: tk.train_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"train_iter[{name}]", "B": 16384,
                          "k": 6, "weighted_first": wf, "max_abs_err_vs_plain": err, **t}),
              flush=True)
    for name, wf in EIKONALS:
        a = cs.synthetic_eik_args(wf, 16384 // 10, 6, 2)
        out = tk.eikonal_iter(*a)
        err, _ = cs._cmp(out, tk.eikonal_iter_plain, a, f"eikonal {name}")
        t = cs.timings(lambda: tk.eikonal_iter(*a), lambda: tk.eikonal_iter_plain(*a))
        print(json.dumps({"checkout": label, "kernel": f"eikonal[{name}]", "n": 16384 // 10,
                          "k": 6, "weighted_first": wf, "max_abs_err_vs_plain": err, **t}),
              flush=True)
    torch.cuda.empty_cache()
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
