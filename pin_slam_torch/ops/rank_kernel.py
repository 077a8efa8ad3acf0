"""Append-time kNN candidate ranking: the CUDA kernels of ``csrc/rank.cu`` and
their plain PyTorch twins.  Counterpart of ``pin_slam_tpu/ops/rank_kernel.py``
together with the brick probe gather that feeds it there
(``pin_slam_tpu/models/neural_points.py`` ``brick_gather_fm``).

Two entry points, one device ranking routine:

- ``probe_rank_brick`` (the main path, brick layout): probes the local hash
  around each group's probe point and ranks the whole brick rows it finds,
  in one launch; the field-major rows are never materialised.
- ``probe_rank`` (the per-cell layout): ranks already gathered field-major
  rows (G, 5K) with columns [x*K | y*K | z*K | lidx*K | gidx*K].

The n queries of group g share group g's ball.  Output: gidx (G,n,k) int32
(-1 where invalid), pos (G,n,k,3) -- the chosen column's xyz, invalid
columns included -- and valid (G,n,k) bool.

None of the Pallas version's TPU workarounds (scoped-VMEM chunking, the
lax.scan over chunks, output aliasing) carry over: one launch covers the
whole (G, n) grid.
"""

from __future__ import annotations

import numpy as np
import torch

from pin_slam_torch.models.neural_points import _INVALID_DIST2, exact_k_min, gather_brick_rows_fm
from pin_slam_torch.ops import _cuda

MAX_K = 16
MAX_KC = 256          # candidates per ball the kernels hold (8 a lane)
_RANK_ARGS = [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F,
              _cuda.P, _cuda.P, _cuda.P, _cuda.P]
_BRICK_ARGS = ([_cuda.P] * 4 + [_cuda.I64, _cuda.P, _cuda.I64] + [_cuda.I] * 8
               + [_cuda.F, _cuda.I, _cuda.I, _cuda.F] + [_cuda.P] * 4)


def probe_rank_plain(rows_fm: torch.Tensor, queries: torch.Tensor, k: int, L: int,
                     max_valid_dist2: float):
    """Plain version: mapper._probe_rank's XLA branch (exact_k_min + select)."""
    G, n = queries.shape[0], queries.shape[1]
    K = rows_fm.shape[1] // 5
    xs, ys, zs, lidx, gidx = rows_fm.view(G, 5, K).unbind(1)
    dx = xs[:, None, :] - queries[..., 0:1]
    dy = ys[:, None, :] - queries[..., 1:2]
    dz = zs[:, None, :] - queries[..., 2:3]
    d2 = dx * dx + dy * dy + dz * dz                              # (G,n,K)
    valid = (lidx[:, None, :] < L) & (d2 <= max_valid_dist2)
    d2m = torch.where(valid, d2, torch.full_like(d2, _INVALID_DIST2))
    sel = exact_k_min(d2m, k)                                     # (G,n,k)

    def pick(a):
        return torch.gather(a[:, None, :].expand(G, n, K), 2, sel)

    valid_k = torch.gather(valid, 2, sel)
    gidx_k = torch.round(pick(gidx)).to(torch.int32)
    pos = torch.stack([pick(xs), pick(ys), pick(zs)], dim=-1)
    return torch.where(valid_k, gidx_k, torch.full_like(gidx_k, -1)), pos, valid_k


def probe_rank_brick_plain(hash_rows, bricks, memb, probe_pts, queries, k: int, L: int,
                           max_valid_dist2: float, voxel_size: float, brick, Hb: int):
    """Plain version of ``probe_rank_brick``: the brick gather to field-major
    rows, then ``probe_rank_plain``."""
    rows_fm = gather_brick_rows_fm(hash_rows, bricks, memb, probe_pts, voxel_size, brick,
                                   Hb, L)
    return probe_rank_plain(rows_fm, queries, k, L, max_valid_dist2)


def _device_of(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts) or dev.type not in ("cpu", "cuda"):
        raise ValueError("rank kernel takes tensors on one CPU or CUDA device")
    return dev


def _check_k(k: int, K: int) -> None:
    if not (1 <= k <= min(K, MAX_K)) or K > MAX_KC:
        raise ValueError(f"rank kernel needs 1 <= k <= min(K={K}, {MAX_K}) and "
                         f"K <= {MAX_KC}, got k={k}")


def _outputs(G: int, n: int, k: int, dev):
    """gidx, pos and valid as views of one allocation."""
    T = G * n * k
    buf = torch.empty((17 * T,), dtype=torch.uint8, device=dev)
    return (buf[:4 * T].view(torch.int32).view(G, n, k),
            buf[4 * T:16 * T].view(torch.float32).view(G, n, k, 3),
            buf[16 * T:].view(torch.bool).view(G, n, k))


def probe_rank(rows_fm: torch.Tensor, queries: torch.Tensor, k: int, L: int,
               max_valid_dist2: float):
    """Rank each query's shared candidate ball of gathered field-major rows;
    CPU tensors take the plain version, CUDA tensors launch ``rank_kernel``."""
    G, n = queries.shape[0], queries.shape[1]
    if rows_fm.dim() != 2 or rows_fm.shape[0] != G or rows_fm.shape[1] % 5:
        raise ValueError(f"rows_fm {tuple(rows_fm.shape)} vs queries {tuple(queries.shape)}")
    K = rows_fm.shape[1] // 5
    _check_k(k, K)
    if queries.dim() != 3 or queries.shape[2] != 3:
        raise ValueError("queries must be (G, n, 3)")
    for t in (rows_fm, queries):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rank kernel takes contiguous float32 tensors")
    dev = _device_of(rows_fm, queries)
    if dev.type == "cpu":
        return probe_rank_plain(rows_fm, queries, k, L, max_valid_dist2)
    gidx, pos, valid = _outputs(G, n, k, dev)
    if G * n == 0:
        return gidx, pos, valid
    f = _cuda.fn("rank", "rank_launch", _RANK_ARGS)
    _cuda.check(f(rows_fm.data_ptr(), queries.data_ptr(), G, n, K, k, L,
                  float(max_valid_dist2), gidx.data_ptr(), pos.data_ptr(),
                  valid.data_ptr(), _cuda.stream_ptr(dev)), "rank_kernel")
    _cuda.COUNTS["rank"] += 1
    return gidx, pos, valid


def probe_rank_brick(hash_rows, bricks, memb, probe_pts, queries, k: int, L: int,
                     max_valid_dist2: float, voxel_size: float, brick, Hb: int):
    """Probe the brick-layout local hash around each group's probe point and
    rank the candidates for each of its queries, in one launch of
    ``rank_brick_kernel`` (CUDA tensors; CPU tensors take the plain
    version).

    hash_rows ((Hb+1)*nsub, 5) float32, the local map's packed table;
    bricks (nsub, Kb, 3) int32 and memb (nsub, Kb*nsub) float32, the probe
    template's parity tables; probe_pts (G, 3); queries (G, n, 3).  The probe
    points and the queries may be row-strided views (each row contiguous)."""
    bx, by, bz = (int(b) for b in brick)
    nsub = bx * by * bz
    if bricks.dim() != 3 or bricks.shape[0] != nsub or bricks.shape[2] != 3:
        raise ValueError(f"bricks {tuple(bricks.shape)} for brick {tuple(brick)}")
    Kb = bricks.shape[1]
    Kc = Kb * nsub
    if tuple(memb.shape) != (nsub, Kc):
        raise ValueError(f"memb {tuple(memb.shape)}, expected {(nsub, Kc)}")
    if hash_rows.numel() != (Hb + 1) * nsub * 5:
        raise ValueError(f"hash_rows {tuple(hash_rows.shape)} for Hb={Hb}, nsub={nsub}")
    G = probe_pts.shape[0]
    if probe_pts.dim() != 2 or probe_pts.shape[1] != 3:
        raise ValueError("probe_pts must be (G, 3)")
    if queries.dim() != 3 or queries.shape[0] != G or queries.shape[2] != 3:
        raise ValueError(f"queries {tuple(queries.shape)} vs probe_pts {tuple(probe_pts.shape)}")
    n = queries.shape[1]
    _check_k(k, Kc)
    if bricks.dtype != torch.int32 or not bricks.is_contiguous():
        raise ValueError("bricks must be contiguous int32")
    for t in (hash_rows, memb):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("hash_rows and memb must be contiguous float32")
    for t in (probe_pts, queries):
        if t.dtype != torch.float32 or t.stride(-1) != 1 or (
                t.dim() == 3 and t.shape[1] > 1 and t.stride(1) != 3):
            raise ValueError("probe_pts and queries must be float32 with contiguous rows")
    dev = _device_of(hash_rows, bricks, memb, probe_pts, queries)
    if dev.type == "cpu":
        return probe_rank_brick_plain(hash_rows, bricks, memb, probe_pts, queries, k, L,
                                      max_valid_dist2, voxel_size, brick, Hb)
    gidx, pos, valid = _outputs(G, n, k, dev)
    if G * n == 0:
        return gidx, pos, valid
    inv_voxel = float(np.float32(1.0) / np.float32(voxel_size))
    f = _cuda.fn("rank", "rank_brick_launch", _BRICK_ARGS)
    _cuda.check(f(hash_rows.data_ptr(), bricks.data_ptr(), memb.data_ptr(),
                  probe_pts.data_ptr(), probe_pts.stride(0), queries.data_ptr(),
                  queries.stride(0), G, n, Kb, nsub, bx, by, bz, Hb, inv_voxel, k, L,
                  float(max_valid_dist2), gidx.data_ptr(), pos.data_ptr(), valid.data_ptr(),
                  _cuda.stream_ptr(dev)), "rank_brick_kernel")
    _cuda.COUNTS["rank_brick"] += 1
    return gidx, pos, valid
