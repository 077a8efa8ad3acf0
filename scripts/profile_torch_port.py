"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 scripts/profile_torch_port.py [A|B|C|H|pe_gaussian] [--warm 3] [--frames 3]
        [--trace-dir DIR] [--root DIR]

Runs chip_smoke.py's path A (bench capacities, weighted_first), B
(run_kitti.yaml at KITTI capacities), C (run_kitti.yaml with PGO on, the
square loop; its loop closes at frame 92, so ``--warm 89 --frames 4``
profiles the closure), H (B with NeRF encoding) or pe_gaussian (A with
Gaussian features), of this checkout or of ``--root`` (another checkout,
e.g. the parent unpacked under ``build/parent``: its chip_smoke paths, its
pin_slam_torch and its slambench) for ``--warm`` frames, then profiles
``--frames`` more with torch.profiler (CPU + CUDA activities), each frame
inside a ``slambench.frame`` range.  The program's own spans
(``pin_slam.<stage>[.<part>]``, ``pin_slam_torch/utils/tracing.py``) are the
labels, and ``slambench.devtrace.reduce_trace`` does the arithmetic.  Prints
one JSON line: wall ms per frame, the device-busy share (the union of the
device operations' intervals over the traced frames), device operations per
frame, the GPU time of each of the port's own kernels and their launches a
frame (the frames' reports, ``info["trace"]["launches"]``), the GPU seconds
launched inside each program span, the idle seconds by the innermost
program span, and the top GPU time by kernel name; the Chrome trace goes to
DIR/profile_<path>.json (default ``build/profiles``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the __global__ functions of pin_slam_torch/csrc
PORT_KERNELS = ("rank_brick_kernel", "rank_kernel", "train_iter_kernel", "eikonal_kernel",
                "train_iter_general_kernel", "eikonal_general_kernel", "reduce_partials",
                "gather_rows_kernel", "scatter_rows_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="A", choices=["A", "B", "C", "H", "pe_gaussian"])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "profiles"))
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    import chip_smoke
    from pin_slam_torch.ops import _cuda
    from slambench import devtrace

    _cuda.build()
    system, frames, _ = chip_smoke.make_path(args.path, args.warm + args.frames)
    system.sync_stages = False
    for fr in frames[:args.warm]:
        system.process_frame(fr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launches = {}
        for fr in frames[args.warm:args.warm + args.frames]:
            with record_function(devtrace.FRAME_SPAN):
                info = system.process_frame(fr)
                torch.cuda.synchronize()
            for name, n in info.get("trace", {}).get("launches", {}).items():
                launches[name] = launches.get(name, 0) + n / args.frames
        wall = time.perf_counter() - t0
    events = prof.events()
    labels = sorted({ev.name for ev in events if ev.name.startswith("pin_slam.")
                     and not devtrace._is_device(ev)})
    red = devtrace.reduce_trace(events, labels, args.frames)
    work = devtrace.gpu_work(events, labels + [devtrace.FRAME_SPAN])
    port = {k: 0.0 for k in PORT_KERNELS}
    for ev in work:
        name = devtrace.kernel_name(ev.name)
        if name in port:
            port[name] += ev.time_range.elapsed_us() / 1e3 / args.frames
    os.makedirs(args.trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.trace_dir, f"profile_{args.path}.json"))
    print(json.dumps({
        "path": args.path, "root": args.root, "frames": args.frames,
        "card": chip_smoke.smi_line(), "wall_ms_per_frame": wall * 1e3 / args.frames,
        "device_busy_share": red["busy_s"] / red["window_s"] if red else None,
        "gpu_ops_per_frame": red["device_ops"] / args.frames if red else None,
        "port_kernel_gpu_ms_per_frame": port,
        "port_kernel_launches_per_frame": launches,
        "gpu_s_by_span": dict(sorted(red.get("device_s_by_span", {}).items(),
                                     key=lambda kv: -kv[1])),
        "idle_s_by_span": red.get("idle_gaps"),
        "top_gpu_s": red.get("top_ops")}))


if __name__ == "__main__":
    main()
