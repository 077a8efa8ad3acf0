"""Surface normals of a registration source cloud, torch counterpart of
``pin_slam_tpu/ops/normals.py``: a per-frame voxel hash over the (already
downsampled) cloud, a 3^3-cell neighbour probe, a masked 3 x 3 covariance,
its smallest eigenvector by a closed form, a planarity test, and orientation
toward the sensor.  The tracker weights each point by ``0.5 + |n . grad|``
with them.

The hash table is filled as ``table.at[slot].set(points)``: where two points
share a slot the last one wins, in index order, as the JAX package's XLA CPU
scatter applies it (``ops/scatter.scatter_set_last``, deterministic on every
device).  Divisions by constants are rounded as the JAX package's compiled
programs round them (``hash3d.div_f32``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pin_slam_torch.ops.hash3d import div_f32, grid_coords, spatial_hash
from pin_slam_torch.ops.scatter import scatter_set_last

_SENTINEL = 1e8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def smallest_eigenvector3(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenpair of symmetric 3 x 3 matrices C (..., 3, 3): the
    eigenvalue by the trigonometric closed form, the eigenvector as the
    longest cross product of two rows of C - lam I (its null direction),
    +z where all three vanish.  Returns (unit eigenvector (..., 3),
    eigenvalue (...,)).  Not ``torch.linalg.eigh``: its signs and rounding
    differ from the JAX package's."""
    a00, a11, a22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    a01, a02, a12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = div_f32(a00 + a11 + a22, 3.0)
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(div_f32(p2, 6.0), min=1e-30))
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    B = (C - q[..., None, None] * eye) / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    phi = div_f32(torch.arccos(torch.clamp(detB * 0.5, -1.0, 1.0)), 3.0)
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    diag_min = torch.minimum(torch.minimum(a00, a11), a22)
    lam = torch.where(p1 < 1e-20, diag_min, lam)

    M = C - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([_cross(r1, r2), _cross(r2, r0), _cross(r0, r1)], dim=-2)
    norms = torch.linalg.norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    n = torch.linalg.norm(vec, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=C.dtype, device=C.device).expand_as(vec)
    vec = torch.where(n > 1e-12, vec / torch.clamp(n, min=1e-12), fallback)
    return vec, lam


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, cell: float,
                     hash_size: int = 1 << 16, min_neighbors: int = 4,
                     max_planarity: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point normals of a padded sensor-frame cloud ``points`` (N, 3)
    with ``valid`` (N,): one point per hash slot of a ``cell`` grid, each
    point's 3^3 neighbouring cells probed, the neighbours within 2 ``cell``
    averaged into a covariance whose smallest eigenvector, turned toward the
    sensor's origin, is the normal.  Returns (unit normals (N, 3), validity
    (N,)): valid where at least ``min_neighbors`` points contributed and the
    neighbourhood is plane-like (smallest eigenvalue below
    ``max_planarity`` times the mean)."""
    dev = points.device
    pts = torch.where(valid[:, None], points, torch.full_like(points, _SENTINEL))
    gc = grid_coords(pts, cell)
    slot = torch.where(valid, spatial_hash(gc, hash_size),
                       torch.full((points.shape[0],), hash_size, dtype=torch.int64, device=dev))
    table = scatter_set_last(torch.full((hash_size + 1, 3), _SENTINEL, dtype=pts.dtype,
                                        device=dev), slot, pts)

    r = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    cells = gc[:, None, :] + offs[None, :, :].to(gc.dtype)            # (N, 27, 3)
    nbr = table[spatial_hash(cells, hash_size)]                        # (N, 27, 3)

    d = nbr - pts[:, None, :]
    dist2 = torch.sum(d * d, dim=-1)
    near = dist2 < (2.0 * cell) ** 2
    cnt = torch.sum(near, dim=-1)

    w = near.to(pts.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    zero = torch.zeros((), dtype=pts.dtype, device=dev)
    mu = torch.sum(torch.where(near[..., None], nbr, zero), dim=1) / wsum
    dc = torch.where(near[..., None], nbr - mu[:, None, :], zero)
    C = torch.einsum("nki,nkj->nij", dc, dc) / wsum[..., None]

    normal, lam_min = smallest_eigenvector3(C)
    trace = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    planar = lam_min < max_planarity * (div_f32(trace, 3.0) + 1e-12)

    toward = -torch.sum(normal * pts, dim=-1)
    normal = torch.where((toward < 0.0)[:, None], -normal, normal)
    return normal, valid & (cnt >= min_neighbors) & planar
