"""Loader of the optional C++ host extension built from ``native/pin_native.cpp``
(the port's own copy of ``pin_slam_tpu/utils/native.py``, plus a builder).

The extension holds two host routines, marching tetrahedra over a masked SDF
grid and k-d tree nearest-neighbour distances, with the signatures of the
numpy versions in ``ops/marching_cubes.py`` and ``eval/mesh.py``, which fall
back to numpy/scipy when it is absent.  It is host code, not a GPU kernel.
It goes through the CPython C API and needs no pybind11.

The loader looks for ``pin_native*.so`` in ``native/`` (where
``cd native && python setup.py build_ext --inplace`` puts it) and in
``build/native/``, where :func:`build` puts it.  :func:`build` runs that same
``native/setup.py``, so the extension has one build recipe.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import subprocess
import sys
import sysconfig
from typing import Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(ROOT, "native", "pin_native.cpp")
BUILD_DIR = os.path.join(ROOT, "build", "native")

_mod = None
_tried = False


def _candidates():
    for d in (os.path.join(ROOT, "native"), BUILD_DIR):
        yield from sorted(glob.glob(os.path.join(d, "pin_native*.so")))


def _load_file(path: str):
    spec = importlib.util.spec_from_file_location("pin_native", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception:
        return None
    return mod


def _load():
    global _mod, _tried
    if not _tried:
        _tried = True
        _mod = next((m for m in map(_load_file, _candidates()) if m is not None), None)
    return _mod


def available() -> bool:
    return _load() is not None


def build(out_dir: str = BUILD_DIR, timeout: float = 300.0) -> str:
    """Build the extension with ``native/setup.py build_ext`` into
    ``out_dir`` (objects under ``out_dir/tmp``; nothing is written into
    ``native/``) and load it in place of any extension loaded before.

    Returns the path of the shared object.  Raises RuntimeError (with the
    compiler's message) when the compiler or the Python headers are missing."""
    global _mod, _tried
    include = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(include, "Python.h")):
        raise RuntimeError(f"no Python.h under {include}")
    out_dir = os.path.abspath(out_dir)
    cmd = [sys.executable, "setup.py", "-q", "build_ext", "--build-lib", out_dir,
           "--build-temp", os.path.join(out_dir, "tmp")]
    try:
        res = subprocess.run(cmd, cwd=os.path.dirname(SOURCE), capture_output=True,
                             text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"setup.py build_ext failed to run: {e!r}") from e
    if res.returncode != 0:
        raise RuntimeError(f"setup.py build_ext exited {res.returncode}: "
                           f"{(res.stdout + res.stderr)[-2000:]}")
    out = os.path.join(out_dir, "pin_native" + sysconfig.get_config_var("EXT_SUFFIX"))
    mod = _load_file(out)
    if mod is None:
        raise RuntimeError(f"built {out} but it does not load")
    _mod, _tried = mod, True
    return out


def marching_tetrahedra(sdf: np.ndarray, mask: Optional[np.ndarray] = None,
                        origin=(0.0, 0.0, 0.0), spacing: float = 1.0,
                        iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    mod = _load()
    assert mod is not None, "native extension not built"
    nx, ny, nz = sdf.shape
    sdf_flat = np.ascontiguousarray(sdf, dtype=np.float64).reshape(-1)
    mask_flat = (np.ascontiguousarray(mask, dtype=np.uint8).reshape(-1)
                 if mask is not None else None)
    vb, fb = mod.marching_tetrahedra(sdf_flat, nx, ny, nz, mask_flat,
                                     float(origin[0]), float(origin[1]),
                                     float(origin[2]), float(spacing), float(iso))
    verts = np.frombuffer(vb, dtype=np.float64).reshape(-1, 3).astype(np.float32)
    faces = np.frombuffer(fb, dtype=np.int64).reshape(-1, 3)
    return verts, faces


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    mod = _load()
    assert mod is not None, "native extension not built"
    s = np.ascontiguousarray(src, dtype=np.float32).reshape(-1)
    d = np.ascontiguousarray(dst, dtype=np.float32).reshape(-1)
    out = mod.nn_distances(s, d)
    return np.frombuffer(out, dtype=np.float32).copy()
