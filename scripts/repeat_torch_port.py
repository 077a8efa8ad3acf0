"""Run-to-run repeatability of the PyTorch/CUDA port's main path on one GPU.

    python3 scripts/repeat_torch_port.py [A|B|C] [--frames 6]

Runs chip_smoke.py's path twice in one process from the same seed and
compares the two runs bit for bit: the global map's features, the decoder,
and the poses.  Then it does the same with the training loop's row scatter
replaced by PyTorch's ``index_add`` (float atomics, what the port used
before its deterministic scatter kernel), to show what atomics do to a run.
Prints one JSON line per variant and the card's name and power limit.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def atomic_scatter(table, idx, val, plan=None, skip_row=None):
    return table.index_add(0, idx, val)


def one_run(path, n_frames):
    import torch

    import chip_smoke

    system, frames, _ = chip_smoke.make_path(path, n_frames)
    for fr in frames[:n_frames]:
        system.process_frame(fr)
    torch.cuda.synchronize()
    feats = system.state.geo_features[:int(system.state.count)].cpu().numpy()
    poses = np.stack(system.dataset.pgo_poses)
    return feats, system.decoder.pack().cpu().numpy(), poses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="A", choices=["A", "B", "C"])
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_torch_port: needs a CUDA device")
    import chip_smoke
    from pin_slam_torch.ops import _cuda, rows

    _cuda.build()
    kernel_scatter = rows.scatter_add_rows
    for name, scatter in (("deterministic scatter kernel", kernel_scatter),
                          ("index_add (float atomics)", atomic_scatter)):
        rows.scatter_add_rows = scatter
        try:
            (f1, d1, p1), (f2, d2, p2) = (one_run(args.path, args.frames) for _ in range(2))
        finally:
            rows.scatter_add_rows = kernel_scatter
        same_shape = f1.shape == f2.shape
        print(json.dumps({
            "path": args.path, "frames": args.frames, "scatter": name,
            "bit_identical": bool(same_shape and np.array_equal(f1, f2)
                                  and np.array_equal(d1, d2) and np.array_equal(p1, p2)),
            "map_points": [int(f1.shape[0]), int(f2.shape[0])],
            "max_abs_feature_diff": float(np.abs(f1 - f2).max()) if same_shape else None,
            "max_abs_decoder_diff": float(np.abs(d1 - d2).max()),
            "max_position_diff_m": float(np.abs(p1[:, :3, 3] - p2[:, :3, 3]).max())}),
            flush=True)
    print(chip_smoke.smi_line(), flush=True)


if __name__ == "__main__":
    main()
