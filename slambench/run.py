"""Run one cell of the benchmark once, on the card this process is given.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compares with
its limit, which also end standard error.  Exits non-zero and prints no
result without enough CUDA devices, or when a module of JAX or of the JAX
package is loaded once the window has closed.

Every cache of the program lives under ``build/`` of the checkout, at fixed
paths: the port's kernels (``build/kernels``, the port's own) and the
directories given here to Triton, torch's extension builder and the CUDA
driver's JIT cache.
"""

from __future__ import annotations

import time

T_NOW = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    /proc/self/stat; the import of this file where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return T_NOW - max(age - (time.perf_counter() - T_NOW), 0.0)
    except (OSError, ValueError, IndexError):
        return T_NOW


def set_cache_dirs(root: str) -> None:
    cache = os.path.join(root, "build", "slambench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    sys.path.insert(0, ROOT)

    import torch

    from slambench import harness

    spec = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"slambench: the cell needs {spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    res = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    found = harness.forbidden_loaded(list(sys.modules))
    if found:
        print(f"slambench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    readings, checks = res.pop("readings"), res.pop("checks")
    print("slambench readings: " + json.dumps(readings), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    res["checks"] = checks
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
