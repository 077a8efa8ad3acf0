"""Frames/s and stage times of one of chip_smoke's paths, for the port in
this checkout or in another one, with the card's SM clock sampled while the
path runs.

    python3 scripts/path_ab.py [--root DIR] [--label NAME] [--path A|B|C]

Runs ``--root``'s own chip_smoke path driver (``run_path``: the same scene,
capacities, stage timing and gates) on ``--root``'s pin_slam_torch, so that
two checkouts (e.g. the parent unpacked under ``build/parent``) can run in
turns in one call: parent, change, change, parent, ...  Prints the path's
JSON line, then one with the label and the SM clock in MHz (median, lowest
and highest of ``nvidia-smi`` samples every 50 ms while the path runs), then
the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--path", default="A", choices=["A", "B", "C"])
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
        cs.run_path(args.path, cap)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
        cap.uninstall()
    mhz = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
    print(json.dumps({"checkout": args.label or root, "path": args.path,
                      "sm_clock_mhz": {"median": float(np.median(mhz)) if mhz else None,
                                       "min": min(mhz, default=None),
                                       "max": max(mhz, default=None), "samples": len(mhz)}}),
          flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
