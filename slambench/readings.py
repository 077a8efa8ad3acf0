"""The check's readings of one cell with the timed path broken underneath:
the control (``faults.CONTROL``) or a fault, or none for a sound run.

    python3 slambench/readings.py --workload <name> --seed <n> --seconds <s> \\
        [--plant train_off|track_off|map_update_off|pose_jump|none]

Runs the cell as ``run.py`` does, on the card, at the cell's own size, and
prints one JSON line: the plant, the seed, ``correct`` under the cell's
limits, ``attempted``, ``failed`` and every reading the check can compare.
The limits in ``slambench/cells/<name>.json`` are set from these readings:
the lower from sound runs over a dozen seeds or more, the upper from the
control's over three or more (PERF.md gives both).  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plant", default="none")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slambench.run import set_cache_dirs

    set_cache_dirs(ROOT)
    import torch

    from slambench import faults, harness

    if not torch.cuda.is_available():
        print("slambench: readings need a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(args.workload, ROOT)
    plant = None if args.plant == "none" else faults.PLANTS[args.plant]
    res = harness.run_cell(spec, args.seed, args.seconds, False, "cuda:0", t_start,
                           plant=plant)
    print(json.dumps({"workload": args.workload, "plant": args.plant, "seed": args.seed,
                      "correct": res["correct"], "attempted": res["attempted"],
                      "failed": res["failed"], "readings": res["readings"],
                      "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
