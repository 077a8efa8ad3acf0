"""Build and load the port's hand-written CUDA kernels.

Every ``pin_slam_torch/csrc/<name>.cu`` is compiled by its own ``nvcc``
process (all started together) into ``build/kernels/lib<name>.so`` at first
use, with a plain C interface, and loaded with ``ctypes``.  Nothing prebuilt
is committed and nothing is fetched: a checkout plus the CUDA toolkit is
enough.  A library is rebuilt when its source (or a ``csrc`` header) is newer.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code, because a
refused launch never runs and a later synchronise would not report it.
``fn`` resolves an entry point and sets its argument types once per process,
so a launch pays one dict lookup for it.

``COUNTS`` holds one launch counter per kernel; each wrapper adds one where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "pin_slam_torch", "csrc")
BUILD = os.path.join(ROOT, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

COUNTS: Dict[str, int] = {"rank_brick": 0, "rank": 0, "train_iter": 0, "eikonal": 0,
                          "gather": 0, "scatter": 0, "track_step": 0, "pool_pass": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_SMS: Dict[int, int] = {}
P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "pin_slam_torch's kernels")


def _lib_path(name: str, out_dir: str = BUILD) -> str:
    return os.path.join(out_dir, f"lib{name}.so")


def _stale(name: str, out_dir: str = BUILD) -> bool:
    out = _lib_path(name, out_dir)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(d) > os.path.getmtime(out) for d in deps)


def build(names: Optional[Iterable[str]] = None, defines: Iterable[str] = (),
          out_dir: str = BUILD) -> Dict[str, float]:
    """Compile the named sources (default: all of csrc/*.cu) in parallel,
    with ``-D`` each of ``defines``, into ``out_dir`` (default
    build/kernels/).  Returns {name: seconds}; raises with nvcc's output on
    failure.  The compiler's register/spill report lands in
    ``out_dir``/<name>.log."""
    if names is None:
        names = sorted(os.path.splitext(os.path.basename(p))[0]
                       for p in glob.glob(os.path.join(CSRC, "*.cu")))
    names = [n for n in names if _stale(n, out_dir)]
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs, t0 = {}, time.perf_counter()
    for n in names:
        tmp = os.path.join(out_dir, f"lib{n}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    secs, errors = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{n}.log"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, _lib_path(n, out_dir))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first use)."""
    if name not in _LIBS:
        if _stale(name):
            build([name])
        _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return _LIBS[name]


def use(name: str, out_dir: str) -> ctypes.CDLL:
    """From now on in this process, launch csrc/<name>.cu's build in
    ``out_dir`` (one made by ``build(..., out_dir=out_dir)``, e.g. with
    instrumenting ``defines``) instead of build/kernels/'s."""
    _LIBS[name] = ctypes.CDLL(_lib_path(name, out_dir))
    for key in [key for key in _FNS if key[0] == name]:
        del _FNS[key]
    return _LIBS[name]


def fn(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of csrc/<name>.cu, resolved (and its
    ``argtypes`` / ``restype`` set) on the first call only; later calls are
    one dict lookup."""
    f = _FNS.get((name, symbol))
    if f is None:
        f = getattr(lib(name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[(name, symbol)] = f
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {code}")


def stream_ptr(device) -> int:
    """The caller's current stream on ``device`` (a torch.device or an index),
    as the raw ``cudaStream_t`` value, read anew on every call."""
    import torch

    if not isinstance(device, int):
        device = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(device)     # builds no Stream object


def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    n = _SMS.get(device_index)
    if n is None:
        import torch

        n = _SMS[device_index] = torch.cuda.get_device_properties(device_index).multi_processor_count
    return n
