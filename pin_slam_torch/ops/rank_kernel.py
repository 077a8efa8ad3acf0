"""Append-time kNN candidate ranking: the CUDA kernel ``csrc/rank.cu`` and its
plain PyTorch twin.  Counterpart of ``pin_slam_tpu/ops/rank_kernel.py``.

The gathered candidate rows arrive field-major, (G, 5K) with columns
[x*K | y*K | z*K | lidx*K | gidx*K]; the n queries of group g share group g's
ball.  Output: gidx (G,n,k) int32 (-1 where invalid), pos (G,n,k,3) — the
chosen column's xyz, invalid columns included — and valid (G,n,k) bool.

None of the Pallas version's TPU workarounds (scoped-VMEM chunking, the
lax.scan over chunks, output aliasing) carry over: the CUDA kernel runs the
whole (G, n) grid in one launch.
"""

from __future__ import annotations

import torch

from pin_slam_torch.models.neural_points import _INVALID_DIST2, exact_k_min
from pin_slam_torch.ops import _cuda

MAX_K = 16


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


def probe_rank(rows_fm: torch.Tensor, queries: torch.Tensor, k: int, L: int,
               max_valid_dist2: float):
    """Rank each query's shared candidate ball; CPU tensors take the plain
    version, CUDA tensors launch ``rank_kernel``."""
    G, n = queries.shape[0], queries.shape[1]
    if rows_fm.dim() != 2 or rows_fm.shape[0] != G or rows_fm.shape[1] % 5:
        raise ValueError(f"rows_fm {tuple(rows_fm.shape)} vs queries {tuple(queries.shape)}")
    K = rows_fm.shape[1] // 5
    if not (1 <= k <= min(K, MAX_K)):
        raise ValueError(f"rank kernel needs 1 <= k <= min(K={K}, {MAX_K}), got k={k}")
    if queries.shape[2] != 3 or queries.device != rows_fm.device:
        raise ValueError("queries must be (G, n, 3) on the rows' device")
    for t in (rows_fm, queries):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("rank kernel takes contiguous float32 tensors")
    if rows_fm.device.type == "cpu":
        return probe_rank_plain(rows_fm, queries, k, L, max_valid_dist2)
    dev = rows_fm.device
    gidx = torch.empty((G, n, k), dtype=torch.int32, device=dev)
    pos = torch.empty((G, n, k, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((G, n, k), dtype=torch.bool, device=dev)
    f = _cuda.fn("rank", "rank_launch",
                 [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
                  _cuda.F, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
    _cuda.check(f(rows_fm.data_ptr(), queries.data_ptr(), G, n, K, k, L,
                  float(max_valid_dist2), gidx.data_ptr(), pos.data_ptr(),
                  valid.data_ptr(), _cuda.stream_ptr(dev)), "rank_kernel")
    _cuda.COUNTS["rank"] += 1
    return gidx, pos, valid
