"""Voxel-grid downsampling as keep-masks, torch counterpart of
``pin_slam_tpu/ops/voxel.py``.

One scatter-min of a packed ``score << idx_bits | index`` word per voxel
slot picks each voxel's winner (closest to the voxel centre, lowest index on
ties).  The JAX package packs into uint32; the port packs the same bits into
int64 and reduces with ``scatter_reduce(amin, include_self=False)``, which is
deterministic, so the keep masks match the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from pin_slam_torch.ops.hash3d import div_f32, grid_coords, spatial_hash

_VAL_BITS = 10
_SENTINEL_U = 0xFFFFFFFF


def _val_bits(n: int) -> int:
    idx_bits = max(1, (int(n) - 1).bit_length())
    vb = min(_VAL_BITS, 32 - idx_bits)
    assert vb >= 4, f"too many points for packed argmin: {n}"
    return vb


def _scatter_argmin_mask(key: torch.Tensor, score_q: torch.Tensor,
                         valid: torch.Tensor, table_size: int) -> torch.Tensor:
    n = key.shape[0]
    idx_bits = 32 - _val_bits(n)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    packed = (score_q.to(torch.int64) << idx_bits) | idx
    packed = torch.where(valid, packed, torch.full_like(packed, _SENTINEL_U))
    slot = torch.where(valid, key, torch.full_like(key, table_size))
    table = torch.full((table_size + 1,), _SENTINEL_U, dtype=torch.int64,
                       device=key.device)
    table = table.scatter_reduce(0, slot, packed, reduce="amin",
                                 include_self=False)
    return (table[slot] == packed) & valid


def sqnorm3(d: torch.Tensor) -> torch.Tensor:
    """(a*a + b*b) + c*c, the JAX package's rounding order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def voxel_down_sample_mask(points: torch.Tensor, valid: torch.Tensor,
                           voxel_size: float, table_size: int) -> torch.Tensor:
    """Keep the point closest to its voxel center. points (N,3); valid (N,)."""
    grid = grid_coords(points, voxel_size)
    key = spatial_hash(grid, table_size)
    center = (grid.to(points.dtype) + 0.5) * voxel_size
    dist2 = sqnorm3(points - center)
    norm = 0.75 * voxel_size * voxel_size
    vb = _val_bits(points.shape[0])
    score_q = torch.clamp((div_f32(dist2, norm) * ((1 << vb) - 1)).to(torch.int32),
                          0, (1 << vb) - 1)
    return _scatter_argmin_mask(key, score_q, valid, table_size)


def voxel_down_sample_min_value_mask(points: torch.Tensor, valid: torch.Tensor,
                                     voxel_size: float, values: torch.Tensor,
                                     table_size: int) -> torch.Tensor:
    """Keep the point with the minimum ``values`` per voxel (lowest index on
    ties); the score is ``values`` quantised over its valid range."""
    grid = grid_coords(points, voxel_size)
    key = spatial_hash(grid, table_size)
    vmax = torch.max(torch.where(valid, values, torch.full_like(values, -float("inf"))))
    vmin = torch.min(torch.where(valid, values, torch.full_like(values, float("inf"))))
    span = torch.clamp(vmax - vmin, min=1e-12)
    vb = _val_bits(points.shape[0])
    score_q = torch.clamp(((values - vmin) / span * ((1 << vb) - 1)).to(torch.int32),
                          0, (1 << vb) - 1)
    return _scatter_argmin_mask(key, score_q, valid, table_size)


def pad_to(points: np.ndarray, n: int, fill=0.0):
    """Host-side helper: pad/truncate [M,...] array to [n,...], return (arr, valid)."""
    m = points.shape[0]
    out = np.full((n,) + points.shape[1:], fill, dtype=points.dtype)
    k = min(m, n)
    out[:k] = points[:k]
    valid = np.zeros((n,), dtype=bool)
    valid[:k] = True
    return out, valid
