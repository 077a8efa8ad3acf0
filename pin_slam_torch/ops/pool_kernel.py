"""The replay pool's re-derivation after a pose change (a loop closure's
pose-graph optimisation, a bundle adjustment): the CUDA kernel
``csrc/pool_pass.cu`` and its plain PyTorch twin.

No TPU kernel stands behind it: the JAX package's ``pool_retransform`` and
``pool_refresh_cache`` are plain jnp under jit.  Eagerly they were two torch
passes over all ``pool_capacity + 1`` rows, the second in 2^20-row chunks;
the kernel reads and writes each row once.  ``pool_pass_plain`` is those two
calls in sequence (``slam/mapper.py``).  Both update ``pool.rows`` in place
from the per-frame poses (T, 4, 4) and the map's attribute rows (positions
and quaternions), keeping every row's cached neighbour ids.

``pool_pass`` runs the twin on CPU tensors and for encoded offset vectors
(``pos_encode`` set: the encoding would need its own arithmetic in the
kernel); on CUDA it launches the kernel for raw 3-vectors at k <= ``MAX_K``
in either layout (``weighted_first`` read from the row width), or raises
(``pool_route``).  Every pass counts ``pool.passes`` in the frame's report.
"""

from __future__ import annotations

from typing import Optional

import torch

from pin_slam_torch.ops import _cuda
from pin_slam_torch.utils import tracing

MAX_K = 8
IDW_EPS = 1e-15             # idw_blend's, which pool_refresh_cache calls
_ARGS = [_cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I64, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
         _cuda.F, _cuda.F, _cuda.P]


def raw_layout(k: int, width: int) -> Optional[bool]:
    """``weighted_first`` of a pool row of ``width`` floats holding k
    neighbours and raw 3-vector offsets (``mapper.pool_layout``): True for
    the blended vector alone, False with the k per-neighbour vectors; None
    for any other width."""
    base = 9 + 2 * k + 3
    return True if width == base else False if width == base + 3 * k else None


def pool_route(k: int, width: int, encoded: bool, cuda: bool) -> str:
    """``"kernel"`` or ``"chunked"`` (the plain twin: CPU tensors, and
    encoded offset vectors on any device); raises NotImplementedError for a
    CUDA pool whose layout the kernel does not take."""
    if not cuda or encoded:
        return "chunked"
    if not 1 <= k <= MAX_K or raw_layout(k, width) is None:
        raise NotImplementedError(
            f"the pool-pass kernel takes k <= {MAX_K} neighbours and raw 3-vector rows of "
            f"9 + 2k + 3 (+ 3k) floats; got k {k}, rows of {width}")
    return "kernel"


def pool_pass_plain(pool, poses: torch.Tensor, attr_rows: torch.Tensor, mc, pos_encode=None):
    """``mapper.pool_retransform`` then ``mapper.pool_refresh_cache``."""
    from pin_slam_torch.slam import mapper as mp

    pool = mp.pool_retransform(pool, poses)
    return mp.pool_refresh_cache(pool, attr_rows, mc, pos_encode)


def _check(rows: torch.Tensor, poses: torch.Tensor, attr_rows: torch.Tensor, cap: int) -> None:
    """Input checks shared by the CPU and CUDA paths, so that the CPU tests
    catch what the kernel would refuse."""
    dev = rows.get_device()
    if (rows.dim() != 2 or rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.data_ptr() % 16 or rows.shape[1] < 12):
        raise ValueError(f"the pool pass takes contiguous 16-byte aligned float32 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if (poses.dim() != 3 or tuple(poses.shape[1:]) != (4, 4) or poses.dtype != torch.float32
            or not poses.is_contiguous() or poses.data_ptr() % 16 or poses.get_device() != dev):
        raise ValueError(f"the pool pass takes contiguous 16-byte aligned float32 (T, 4, 4) "
                         f"poses on the rows' device, got {tuple(poses.shape)} {poses.dtype}")
    if (attr_rows.dim() != 2 or attr_rows.dtype != torch.float32 or attr_rows.stride(1) != 1
            or attr_rows.stride(0) % 4 or attr_rows.data_ptr() % 16 or attr_rows.shape[1] < 8
            or attr_rows.shape[0] <= cap or attr_rows.get_device() != dev):
        raise ValueError(f"the pool pass takes float32 attribute rows of >= 8 columns, 16-byte "
                         f"aligned, with the sentinel row {cap}, on the rows' device; got "
                         f"{tuple(attr_rows.shape)} {attr_rows.dtype}")


def pool_pass(pool, poses: torch.Tensor, attr_rows: torch.Tensor, mc, pos_encode=None):
    """Re-derive every pool row's world coordinates from ``poses`` and its
    cached kNN geometry from ``attr_rows`` (in place; ``mc.nn_k`` neighbours,
    ``mc.capacity`` the sentinel row).  Returns the pool."""
    rows = pool.rows
    _check(rows, poses, attr_rows, mc.capacity)
    tracing.count("pool.passes", 1)
    k = mc.nn_k
    if pool_route(k, rows.shape[1], pos_encode is not None, rows.is_cuda) == "chunked":
        return pool_pass_plain(pool, poses, attr_rows, mc, pos_encode)
    dev = rows.get_device()
    f = _cuda.fn("pool_pass", "pool_pass_launch", _ARGS)
    _cuda.check(f(rows.data_ptr(), poses.data_ptr(), attr_rows.data_ptr(), rows.shape[0],
                  mc.capacity, poses.shape[0], attr_rows.stride(0), k,
                  int(raw_layout(k, rows.shape[1])), mc.max_valid_dist2, IDW_EPS,
                  _cuda.stream_ptr(dev)), "pool_pass_kernel")
    _cuda.COUNTS["pool_pass"] += 1
    return pool
