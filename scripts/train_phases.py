"""Where the time goes inside the train kernel, and inside the general forms
of the train and eikonal kernels, phase by phase, on one GPU.

    python3 scripts/train_phases.py [--general-only]

Builds ``pin_slam_torch/csrc/train_iter.cu`` with ``-DTRAIN_STAMPS`` into
``build/phases`` (thread 0 of every block reads ``clock64()`` at the kernel's
start, after each phase's barrier and at its end), makes it the build that
``train_kernel.train_iter`` launches, and runs the wrapper at path A's and
path B's shapes (B = 16384, k = 6, both modes, chip_smoke's seeded random
inputs).  Prints one JSON line per shape: the median and the largest cycles
of each phase over the blocks, the block's total, the launch, and the
instrumented build's registers.  Then the card's name and power limit.  The
stamps cost a few registers, so the launch may differ from the plain
build's; read the shares, not the totals.

Then (or alone, with ``--general-only``) the same for the general forms
(VD != 3): both sources built with ``-DGEN_STAMPS`` into
``build/phases_gen`` (thread 0 of each block sums the cycles of each phase
over the groups of rows the block takes: staging, forward, per-row loss,
backward, feature gradients; then the block's partial row), run at path H's shapes
(per neighbour, VD 27) and pe_gaussian's (weighted_first, VD 35): the train
kernel at B = 16384, the eikonal kernel at n = 1638, k = 6.
"""

import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the phases between the kernel's stamps (weighted_first's input blend ends
# inside a branch, so it counts with the forward pass)
PHASES = ["staging", "forward (with weighted_first's input blend)", "per-row BCE", "backward",
          "feature-gradient copy and warp sums", "block sums"]
STAMP_BLOCKS = 4096   # blocks stamped (csrc/train_iter.cu, gen:: in csrc/train_common.cuh)
GEN_PHASES = ["staging", "forward", "per-row loss", "backward", "feature gradients",
              "block sums"]
# (label, weighted_first, VD): the general forms' shapes on path H and pe_gaussian
GEN_SHAPES = [("H", False, 27), ("pe_gaussian", True, 35)]


def general_phases(cs):
    """The general forms' phase cycles at ``GEN_SHAPES`` (see the module
    docstring), one JSON line per kernel and shape."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    out_dir = os.path.join(ROOT, "build", "phases_gen")
    _cuda.build(["train_iter", "eikonal"], defines=["GEN_STAMPS"], out_dir=out_dir)
    buf = np.zeros((STAMP_BLOCKS, len(GEN_PHASES)), np.int64)
    for kernel in ("train_iter", "eikonal"):
        with open(os.path.join(out_dir, f"{kernel}.log")) as f:
            log = f.read()
        regs = [int(r) for r in re.findall(r"general_kernel.*?Used (\d+) registers", log, re.S)]
        _cuda.use(kernel, out_dir)
        stamps = _cuda.fn(kernel, f"{kernel}_general_stamps", [_cuda.P])
        for name, wf, vd in GEN_SHAPES:
            k = 6
            if kernel == "train_iter":
                n, per, staged = 16384, 1 if wf else k, wf
                args = cs.synthetic_train_args(wf, n, k, 1, vd=vd)
                run = lambda: tk.train_iter(*args)
            else:
                n, per, staged = 1638, 6 * (1 if wf else k), True
                args = cs.synthetic_eik_args(wf, n, k, 2, vd=vd)
                run = lambda: tk.eikonal_iter(*args)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            _cuda.check(stamps(buf.ctypes.data), "stamps copy")
            resident = tk.general_resident_blocks(kernel, 0, wf, vd)
            R = tk.general_rows_per_block(n, per, k, staged, resident)
            groups = -(-n // R)
            nblocks = min(groups, resident)
            d = buf[:nblocks]
            print(json.dumps({
                "kernel": f"{kernel} general", "shape": {"path": name, "n": n, "k": k, "VD": vd,
                                                         "weighted_first": wf},
                "launch": {"width": tk.general_width(vd), "rows_per_block": R,
                           "groups": groups, "blocks": nblocks, "threads": tk.GEN_THREADS,
                           "resident_blocks": resident},
                "registers": regs,
                "phase_cycles_median": dict(zip(GEN_PHASES, np.median(d, 0).tolist())),
                "phase_cycles_max": dict(zip(GEN_PHASES, d.max(0).tolist())),
                "block_cycles_median": float(np.median(d.sum(1))),
                "block_cycles_max": int(d.sum(1).max())}), flush=True)


def main():
    import torch

    import chip_smoke as cs
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("train_phases: needs a CUDA device")
    if "--general-only" in sys.argv[1:]:
        general_phases(cs)
        print(cs.smi_line(), flush=True)
        return
    out_dir = os.path.join(ROOT, "build", "phases")
    _cuda.build(["train_iter"], defines=["TRAIN_STAMPS"], out_dir=out_dir)
    with open(os.path.join(out_dir, "train_iter.log")) as f:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", f.read())]
    _cuda.use("train_iter", out_dir)
    stamps = _cuda.fn("train_iter", "train_iter_stamps", [_cuda.P])
    buf = np.zeros((STAMP_BLOCKS, len(PHASES) + 1), np.int64)
    for name, wf in (("A", True), ("B", False)):
        B, k = 16384, 6
        args = cs.synthetic_train_args(wf, B, k, 1)
        for _ in range(3):
            tk.train_iter(*args)
        torch.cuda.synchronize()
        _cuda.check(stamps(buf.ctypes.data), "stamps copy")
        resident = tk.train_resident_blocks(0, wf)
        R = tk.train_rows_per_block(B, k, wf, resident)
        nblocks = -(-B // R)
        if nblocks > STAMP_BLOCKS:
            raise SystemExit(f"train_phases: {nblocks} blocks, {STAMP_BLOCKS} stamped")
        d = np.diff(buf[:nblocks], axis=1)
        print(json.dumps({
            "shape": {"path": name, "B": B, "k": k, "weighted_first": wf},
            "launch": {"rows_per_block": R, "blocks": nblocks, "threads": tk.TRAIN_THREADS,
                       "resident_blocks": resident},
            "registers": regs,
            "phase_cycles_median": dict(zip(PHASES, np.median(d, 0).tolist())),
            "phase_cycles_max": dict(zip(PHASES, d.max(0).tolist())),
            "block_cycles_median": float(np.median(buf[:nblocks, -1] - buf[:nblocks, 0]))}),
            flush=True)
    general_phases(cs)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
