"""Where the time goes inside the train kernel, phase by phase, on one GPU.

    python3 scripts/train_phases.py

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
STAMP_BLOCKS = 4096   # blocks stamped (csrc/train_iter.cu)


def main():
    import torch

    import chip_smoke as cs
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("train_phases: needs a CUDA device")
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
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
