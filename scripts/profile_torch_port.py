"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 scripts/profile_torch_port.py [A|B] [--warm 3] [--frames 3] [--trace-dir DIR]

Runs chip_smoke.py's path A (bench capacities, weighted_first) or B
(run_kitti.yaml at KITTI capacities) for ``--warm`` frames, then profiles
``--frames`` more with torch.profiler (CPU + CUDA activities).  Prints one
JSON line: wall ms per frame, the device-busy share (sum of GPU kernel and
memcpy time over the window's wall time), the number of kernel launches per
frame, and the top GPU time by kernel name; the Chrome trace goes to
DIR/profile_<path>.json (default ``build/profiles``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="A", choices=["A", "B"])
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "profiles"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    import chip_smoke
    from pin_slam_torch.ops import _cuda

    _cuda.build()
    system, frames, _ = chip_smoke.make_path(args.path, args.warm + args.frames)
    system.sync_stages = False
    for fr in frames[:args.warm]:
        system.process_frame(fr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames[args.warm:]:
            system.process_frame(fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gpu = {}
    n_kernels, busy_us = 0, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            gpu[ev.name] = gpu.get(ev.name, 0.0) + us
            busy_us += us
            n_kernels += 1
    top = sorted(gpu.items(), key=lambda kv: -kv[1])[:25]
    os.makedirs(args.trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.trace_dir, f"profile_{args.path}.json"))
    smi = chip_smoke.smi_line()
    print(json.dumps({
        "path": args.path, "frames": args.frames, "card": smi,
        "wall_ms_per_frame": wall * 1e3 / args.frames,
        "device_busy_share": busy_us / 1e6 / wall,
        "gpu_ops_per_frame": n_kernels / args.frames,
        "top_gpu_ms_per_frame": [(name[:90], us / 1e3 / args.frames) for name, us in top]}))


if __name__ == "__main__":
    main()
