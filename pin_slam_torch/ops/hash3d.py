"""3-D spatial hashing (voxel-grid keys), torch counterpart of
``pin_slam_tpu/ops/hash3d.py``.

The JAX package multiplies and accumulates in uint32 (wrap-around = mod
2^32) before the final mod.  torch's uint32 has gaps on CUDA, so the port
computes in int64, masks to 32 bits after every step, then takes the mod:
the slots are bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

PRIMES = (73856093, 19349669, 83492791)
_MASK32 = 0xFFFFFFFF


def div_f32(x: torch.Tensor, s: float) -> torch.Tensor:
    """float32 ``x / s`` for a constant ``s``, rounded as the JAX package's
    compiled programs round it: XLA rewrites division by a constant into
    multiplication by its float32 reciprocal, which moves points that sit on
    a voxel boundary into the neighbouring voxel compared with a true
    division.  Matching it keeps hash slots and keep masks identical."""
    return x * float(np.float32(1.0) / np.float32(s))


def grid_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(p / voxel) as int32 [...,3]."""
    return torch.floor(div_f32(points, voxel_size)).to(torch.int32)


def spatial_hash(grid: torch.Tensor, table_size: int) -> torch.Tensor:
    """Hash int32 grid coords [...,3] -> int64 slot index in [0, table_size)."""
    g = grid.to(torch.int64) & _MASK32          # two's-complement -> uint32 bits
    h = (g[..., 0] * PRIMES[0]) & _MASK32
    h = (h + ((g[..., 1] * PRIMES[1]) & _MASK32)) & _MASK32
    h = (h + ((g[..., 2] * PRIMES[2]) & _MASK32)) & _MASK32
    return h % table_size
