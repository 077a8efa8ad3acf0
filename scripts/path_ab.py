"""Frames/s and stage times of one of chip_smoke's paths, for the port in
this checkout or in another one, with the card's SM clock sampled while the
path runs.

    python3 scripts/path_ab.py [--root DIR] [--label NAME] [--path A|B|C|H|pe_gaussian]
        [--loop-reps N]

Runs ``--root``'s own chip_smoke path driver (``run_path``: the same scene,
capacities, stage timing and gates) on ``--root``'s pin_slam_torch, so that
two checkouts (e.g. the parent unpacked under ``build/parent``) can run in
turns in one call: parent, change, change, parent, ...  Prints the path's
JSON line, then one with the label and the SM clock in MHz (median, lowest
and highest of ``nvidia-smi`` samples every 50 ms while the path runs), then
the card's name and power limit.  Needs a CUDA device.

With ``--loop-reps N`` it runs no path: it builds the path's system, runs
its first two frames, samples one frame's batch indices and times the
training call (``mapper.mapping_loop_cached`` from clones of that state,
synchronised before and after) N times: the training call's wall time
(host launch path and device) without the rest of the frame, as the
median, lowest and highest ms; the median ms until the call returns on the
host, before the synchronise (near the wall time: the host sets it); and
the kernel launches of one call.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_loop(cs, path, reps):
    """The training call's synchronised ms on the path's third frame's state
    (see the module docstring), ``reps`` times."""
    import time

    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp

    system, frames, _ = cs.make_path(path, 3)
    for fr in frames[:2]:
        system.process_frame(fr)
    cfg, mc, mcfg, lm = system.config, system.mc, system.mcfg, system.lm
    feats, gvec = system._with_cert_column(lm), system.decoder.pack()
    gen = torch.Generator(device="cuda").manual_seed(11)
    idx = mp.sample_batch_indices(gen, system.pool, mcfg, torch.tensor(True, device="cuda"),
                                  int(cfg.iters))
    ms, enq, launches = [], [], None
    for _ in range(reps + 1):                # the first call warms up
        f, g = feats.clone(), gvec.clone()
        args = (cs._clone(lm), mc, f, g, mp.init_opt_state(f, g), system.pool, mcfg, idx, 1.0,
                system.after_pgo)
        before = dict(_cuda.COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mp.mapping_loop_cached(*args)
        enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: n - before[k] for k, n in _cuda.COUNTS.items() if n != before[k]}
    ms, enq = ms[1:], enq[1:]
    return {"loop_ms": {"median": float(np.median(ms)), "min": min(ms), "max": max(ms),
                        "reps": reps},
            "enqueue_ms_median": float(np.median(enq)), "iters": int(cfg.iters),
            "launches_per_call": launches}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--path", default="A", choices=["A", "B", "C", "H", "pe_gaussian"])
    ap.add_argument("--loop-reps", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_paths",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("path_ab: needs a CUDA device")
    from pin_slam_torch.ops import _cuda

    _cuda.build()
    cap = cs.Capture()
    cap.install()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        if args.loop_reps:
            loop = time_loop(cs, args.path, args.loop_reps)
        else:
            cs.run_path(args.path, cap)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
        cap.uninstall()
    if args.loop_reps:
        print(json.dumps({"checkout": args.label or root, "path": args.path, **loop}), flush=True)
    mhz = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    print(json.dumps({"checkout": args.label or root, "path": args.path,
                      "sm_clock_mhz": {"median": float(np.median(mhz)) if mhz else None,
                                       "min": min(mhz, default=None),
                                       "max": max(mhz, default=None), "samples": len(mhz)}}),
          flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
