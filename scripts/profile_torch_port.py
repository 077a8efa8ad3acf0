"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 scripts/profile_torch_port.py [A|B|C|H|pe_gaussian] [--warm 3] [--frames 3]
        [--trace-dir DIR] [--root DIR]

Runs chip_smoke.py's path A (bench capacities, weighted_first), B
(run_kitti.yaml at KITTI capacities), C (run_kitti.yaml with PGO on, the
square loop; its loop closes at frame 92, so ``--warm 89 --frames 4``
profiles the closure), H (B with NeRF encoding) or pe_gaussian (A with
Gaussian features), of this checkout or of ``--root`` (another checkout,
e.g. the parent unpacked under ``build/parent``: its chip_smoke paths and
its pin_slam_torch) for ``--warm`` frames, then profiles ``--frames`` more
with torch.profiler (CPU + CUDA activities).  Prints one
JSON line: wall ms per frame, the device-busy share (sum of GPU kernel and
memcpy time over the window's wall time), the number of kernel launches per
frame, the GPU time of each of the port's own kernels, the GPU time by the
function that launched it (``SPANS``, each wrapped in a
``torch.profiler.record_function`` range for the profiled frames only; a
kernel is charged to the ranges that contain its launch call on the host,
outermost first), and the top GPU time by kernel name; the Chrome trace goes
to DIR/profile_<path>.json (default ``build/profiles``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, attribute) of the functions whose GPU time is reported apart; the
# pipeline calls each through that attribute
SPANS = [
    ("pin_slam_torch.slam.pipeline", "SlamSystem._source_prep"),
    ("pin_slam_torch.slam.tracker", "track_frame"),
    ("pin_slam_torch.slam.pipeline", "sample_rays"),
    ("pin_slam_torch.models.neural_points", "map_insert"),
    ("pin_slam_torch.models.neural_points", "build_local_map"),
    ("pin_slam_torch.slam.mapper", "compute_new_sample_mask"),
    ("pin_slam_torch.slam.mapper", "append_knn"),
    ("pin_slam_torch.slam.mapper", "pool_append"),
    ("pin_slam_torch.slam.mapper", "mapping_loop_cached"),
    ("pin_slam_torch.slam.loop_detector", "NeuralPointMapContextManager.add_node_device"),
    ("pin_slam_torch.slam.pipeline", "SlamSystem._loop_closure_stage"),
    ("pin_slam_torch.models.neural_points", "adjust_map"),
    ("pin_slam_torch.models.neural_points", "recreate_hash"),
    ("pin_slam_torch.slam.mapper", "pool_retransform"),
    ("pin_slam_torch.slam.mapper", "pool_refresh_cache"),
]
# the __global__ functions of pin_slam_torch/csrc
PORT_KERNELS = ("rank_brick_kernel", "rank_kernel", "train_iter_kernel", "eikonal_kernel",
                "train_iter_general_kernel", "eikonal_general_kernel", "reduce_partials",
                "gather_rows_kernel", "scatter_rows_kernel")


def install_spans():
    """Wrap every SPANS function in a record_function range named after it;
    returns the undo list."""
    import functools
    import importlib

    from torch.profiler import record_function

    undo = []
    for mod, attr in SPANS:
        owner = importlib.import_module(mod)
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        fn = getattr(owner, name)

        def wrapped(*a, __fn=fn, __label=attr, **kw):
            with record_function(__label):
                return __fn(*a, **kw)

        setattr(owner, name, functools.wraps(fn)(wrapped))
        undo.append((owner, name, fn))
    return undo


def kernel_name(name):
    """'void ns::foo<T>(float const*, ...)' -> 'foo'; a name without that
    shape (a copy, a memset) is returned as it is."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return head[-1].split("::")[-1] if head else name


def gpu_work(events):
    """The device-side kernels and copies; the profiler also mirrors every
    record_function range onto the device as a user annotation, which is not
    work."""
    import torch

    labels = {attr for _, attr in SPANS}
    return [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False) and ev.name not in labels]


def gpu_ms_by_span(events, work, n_frames):
    """GPU ms per frame by the chain of SPANS ranges around each kernel's
    launch on the host (matched by correlation id), '(none)' outside them,
    with the chain's three largest kernels."""
    import torch

    labels = {attr for _, attr in SPANS}
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in events
              if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in labels]
    # the CUDA API calls that launched work (cudaLaunchKernel,
    # cuLaunchKernel, cudaMemcpyAsync, ...) carry the kernel's correlation id
    launch_at = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name.startswith("cu"):
            launch_at.setdefault(ev.id, ev.time_range.start)
    per = {}
    for ev in work:
        t = launch_at.get(ev.id)
        chain = sorted((a, b - a, name) for a, b, name in ranges
                       if t is not None and a <= t <= b)
        key = " > ".join(name for _, _, name in chain) or "(none)"
        k = per.setdefault(key, {})
        name = kernel_name(ev.name)
        k[name] = k.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / n_frames
    out = {key: {"ms": sum(k.values()),
                 "top": sorted(k.items(), key=lambda kv: -kv[1])[:3]}
           for key, k in per.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


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
    undo = install_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames[args.warm:args.warm + args.frames]:
            system.process_frame(fr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for owner, name, fn in undo:
        setattr(owner, name, fn)
    events = prof.events()
    work = gpu_work(events)
    gpu = {}
    for ev in work:
        gpu[ev.name] = gpu.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    busy_us = sum(gpu.values())
    top = sorted(gpu.items(), key=lambda kv: -kv[1])[:25]
    port = {k: sum(us for name, us in gpu.items() if kernel_name(name) == k) / 1e3 / args.frames
            for k in PORT_KERNELS}
    os.makedirs(args.trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.trace_dir, f"profile_{args.path}.json"))
    smi = chip_smoke.smi_line()
    print(json.dumps({
        "path": args.path, "root": args.root, "frames": args.frames, "card": smi,
        "wall_ms_per_frame": wall * 1e3 / args.frames,
        "device_busy_share": busy_us / 1e6 / wall,
        "gpu_ops_per_frame": len(work) / args.frames,
        "port_kernel_gpu_ms_per_frame": port,
        "gpu_ms_per_frame_by_span": gpu_ms_by_span(events, work, args.frames),
        "top_gpu_ms_per_frame": [(name[:90], us / 1e3 / args.frames) for name, us in top]}))


if __name__ == "__main__":
    main()
