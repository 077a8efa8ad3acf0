"""Run-to-run repeatability of the PyTorch/CUDA port's main path on one GPU,
for the port in this checkout or in another one.

    python3 scripts/repeat_torch_port.py [A|B|C] [--frames 6] [--root DIR] [--label NAME]

Runs ``--root``'s chip_smoke path twice in one process from the same seed
(``--root`` names another checkout, for example the parent commit unpacked
under ``build/parent``; by default this one) and compares the two runs bit
for bit: the global map's features, the decoder, and the poses.  Each run's
sha256 digests of the poses, the features and the decoder are printed, so
that two checkouts can be compared bit for bit across processes.  Then it
does the same with the training loop's row scatter replaced by PyTorch's
``index_add`` (float atomics, what the port used before its deterministic
scatter kernel), to show what atomics do to a run: it patches whichever
scatter that checkout's mapper calls (``scatter_sum_rows``, or
``scatter_add_rows`` where there is none) and fails if the patch was never
called.  Prints one JSON line per variant and the card's name and power
limit.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def atomic_sum(n_rows, idx, val, plan=None, skip_row=None):
    return val.new_zeros((n_rows, val.shape[1])).index_add_(0, idx, val)


def atomic_add(table, idx, val, plan=None, skip_row=None):
    return table.index_add(0, idx, val)


def one_run(cs, path, n_frames):
    import torch

    system, frames, _ = cs.make_path(path, n_frames)
    for fr in frames[:n_frames]:
        system.process_frame(fr)
    torch.cuda.synchronize()
    feats = system.state.geo_features[:int(system.state.count)].cpu().numpy()
    poses = np.stack(system.dataset.pgo_poses)
    return feats, system.decoder.pack().cpu().numpy(), poses


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="A", choices=["A", "B", "C"])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_paths",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("repeat_torch_port: needs a CUDA device")
    from pin_slam_torch.ops import _cuda, rows

    if os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(_cuda.__file__)))) != root:
        raise SystemExit(f"repeat_torch_port: imported pin_slam_torch from {_cuda.__file__}, "
                         f"not {root}")
    _cuda.build()
    name = "scatter_sum_rows" if hasattr(rows, "scatter_sum_rows") else "scatter_add_rows"
    kernel_scatter = getattr(rows, name)
    calls = {"n": 0}

    def atomic(*a, **kw):
        calls["n"] += 1
        return (atomic_sum if name == "scatter_sum_rows" else atomic_add)(*a, **kw)

    for label, scatter in (("deterministic scatter kernel", kernel_scatter),
                           ("index_add (float atomics)", atomic)):
        setattr(rows, name, scatter)
        try:
            (f1, d1, p1), (f2, d2, p2) = (one_run(cs, args.path, args.frames) for _ in range(2))
        finally:
            setattr(rows, name, kernel_scatter)
        if scatter is atomic and calls["n"] == 0:
            raise SystemExit(f"repeat_torch_port: the patched rows.{name} was never called")
        same_shape = f1.shape == f2.shape
        print(json.dumps({
            "checkout": args.label or root, "path": args.path, "frames": args.frames,
            "scatter": label, "patched": name,
            "bit_identical": bool(same_shape and np.array_equal(f1, f2)
                                  and np.array_equal(d1, d2) and np.array_equal(p1, p2)),
            "sha256": [{"poses": digest(p), "features": digest(f), "decoder": digest(d)}
                       for p, f, d in ((p1, f1, d1), (p2, f2, d2))],
            "map_points": [int(f1.shape[0]), int(f2.shape[0])],
            "max_abs_feature_diff": float(np.abs(f1 - f2).max()) if same_shape else None,
            "max_abs_decoder_diff": float(np.abs(d1 - d2).max()),
            "max_position_diff_m": float(np.abs(p1[:, :3, 3] - p2[:, :3, 3]).max())}),
            flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
