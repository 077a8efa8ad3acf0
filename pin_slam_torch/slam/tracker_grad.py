"""Closed-form d(SDF)/d(query point) for the tracker's inner loop, torch
counterpart of ``pin_slam_tpu/slam/tracker_grad.py`` (both interpolation
modes, no positional encoding).  After a pose-graph optimisation
(``after_pgo``) every offset vector v_i is rotated into its neighbour's
frame by the passive rotation R_i of the neighbour's quaternion.

    sdf(p)  = s * MLP(h),  h = sum_i w_i(p) [f_i ; R_i v_i(p)]        (weighted_first)
    sdf(p)  = sum_i w_i(p) o_i,  o_i = s * MLP([f_i ; R_i v_i(p)])     (per neighbour)
    dw_i/dp = (dwhat_i - w_i sum_j dwhat_j) / S,  dwhat_i = -2 v_i whati^2
    d(R_i v_i)/dp ^T g = R_i^T g  (the active rotation by the same quaternion)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.neural_points import _INVALID_DIST2
from pin_slam_torch.ops.transforms import _cross, apply_quaternion_rotation
from pin_slam_torch.ops.voxel import sqnorm3


def _mlp_value_and_input_grad(layers, h: torch.Tensor, sdf_scale: float):
    """Forward through the Linear-ReLU trunk + manual backprop to the input.
    layers: [(W (in,out), b)] hidden first, output last.  Returns (sdf, g_h)."""
    masks = []
    x = h
    for W, b in layers[:-1]:
        z = x @ W
        if b is not None:
            z = z + b
        masks.append(z > 0)
        x = torch.relu(z)
    W_out, b_out = layers[-1]
    out = x @ W_out
    if b_out is not None:
        out = out + b_out
    sdf = out[..., 0] * sdf_scale
    g = (W_out[:, 0] * sdf_scale).expand(x.shape)
    for mask, (W, _) in zip(reversed(masks), reversed(layers[:-1])):
        g = (g * mask) @ W.T
    return sdf, g


def _rotate_back(quat, g):
    """R^T g for the passive rotation R of ``quat``: the active rotation."""
    quat_w, quat_xyz = quat[..., :1], quat[..., 1:]
    t2 = 2.0 * _cross(quat_xyz, g)
    return g + quat_w * t2 + _cross(quat_xyz, t2)


def _weights(pts, nbr_pos, quat, feats, valid, eps):
    v_raw = pts[:, None, :] - nbr_pos
    d2 = torch.where(valid, sqnorm3(v_raw), torch.full_like(v_raw[..., 0], _INVALID_DIST2))
    v = v_raw if quat is None else apply_quaternion_rotation(quat, v_raw)
    v = torch.where(valid[..., None], v, torch.zeros_like(v))
    feats = torch.where(valid[..., None], feats, torch.zeros_like(feats))
    w_hat, S, w = npts.idw_weights(d2, valid, eps)
    dw_hat = -2.0 * v_raw * (w_hat ** 2)[..., None]
    dw_hat = torch.where(valid[..., None], dw_hat, torch.zeros_like(dw_hat))
    sum_dw = torch.sum(dw_hat, dim=1, keepdim=True)
    dw = (dw_hat - w[..., None] * sum_dw) / S[..., None]
    return v, feats, w, dw


def _core(mc, layers, sdf_scale, pts, nbr_pos, quat, feats, valid):
    """weighted_first: (B,k) selected neighbours -> (sdf, grad).  ``quat``
    (B,k,4) after a pose-graph optimisation, else None."""
    v, feats, w, dw = _weights(pts, nbr_pos, quat, feats, valid, mc.idw_eps)
    fv = torch.cat([feats, v], dim=-1)
    h = torch.sum(fv * w[..., None], dim=1)
    sdf, g_h = _mlp_value_and_input_grad(layers, h, sdf_scale)
    a = torch.einsum("bkd,bd->bk", fv, g_h)
    grad = torch.einsum("bk,bkj->bj", a, dw)
    g_v = g_h[:, None, -3:].expand(dw.shape)
    if quat is not None:
        g_v = _rotate_back(quat, g_v)
    grad = grad + torch.einsum("bk,bkj->bj", w, g_v)
    return sdf, grad


def _core_pn(mc, layers, sdf_scale, pts, nbr_pos, quat, feats, valid):
    """Per-neighbour decode + prediction blend: (sdf, grad, IDW-weighted std)."""
    v, feats, w, dw = _weights(pts, nbr_pos, quat, feats, valid, mc.idw_eps)
    B, k = w.shape
    fv = torch.cat([feats, v], dim=-1)
    o_flat, g_flat = _mlp_value_and_input_grad(layers, fv.reshape(B * k, -1), sdf_scale)
    o = o_flat.reshape(B, k)
    g_in = g_flat.reshape(B, k, -1)
    sdf = torch.sum(w * o, dim=1)
    sdf_std = torch.sqrt(torch.clamp(torch.sum(w * (o - sdf[:, None]) ** 2, dim=1), min=0.0))
    grad = torch.einsum("bk,bkj->bj", o, dw)
    g_v = g_in[..., -3:]
    if quat is not None:
        g_v = _rotate_back(quat, g_v)
    grad = grad + torch.einsum("bk,bkj->bj", w, g_v)
    return sdf, grad, sdf_std


class CandCache(NamedTuple):
    """Per-source-point probe candidates, probed once per probe pose."""
    xs: torch.Tensor     # (B,M) candidate x (invalid -> 1e5)
    ys: torch.Tensor
    zs: torch.Tensor
    lidx: torch.Tensor   # (B,M) int64 local indices, sentinel = local_capacity


def probe_candidates(lm: npts.LocalMap, mc: npts.MapConfig, pts: torch.Tensor,
                     offsets, keep: int = 16) -> CandCache:
    """One hash-row gather of the neighbour template at ``pts`` (whole brick
    rows with a ProbeTemplate on a brick-layout map), pre-ranked to the
    nearest ``keep`` candidates."""
    L = mc.local_capacity
    if isinstance(offsets, npts.ProbeTemplate) and mc.nsub > 1:
        rows_fm = npts.brick_gather_fm(lm, mc, offsets, pts)
        Kc = rows_fm.shape[1] // 5
        xs, ys, zs = rows_fm[:, :Kc], rows_fm[:, Kc:2 * Kc], rows_fm[:, 2 * Kc:3 * Kc]
        lidx = rows_fm[:, 3 * Kc:4 * Kc].to(torch.int64)
    else:
        cells_t = offsets.cells if isinstance(offsets, npts.ProbeTemplate) else offsets
        grid = npts.grid_coords(pts, mc.voxel_size)
        rows = lm.hash_rows[npts.subcell_hash(mc, grid[:, None, :] + cells_t[None].to(grid.dtype))]
        Kc = cells_t.shape[0]
        xs, ys, zs = rows[..., 0], rows[..., 1], rows[..., 2]
        lidx = rows[..., 3].to(torch.int64)
    valid = lidx < L
    far = torch.full_like(xs, 1e5)
    xs, ys, zs = (torch.where(valid, a, far) for a in (xs, ys, zs))
    lidx = torch.where(valid, lidx, torch.full_like(lidx, L))
    M = max(min(keep, Kc), mc.nn_k)
    if M >= Kc:
        return CandCache(xs=xs, ys=ys, zs=zs, lidx=lidx)
    d2 = (xs - pts[:, 0:1]) ** 2 + (ys - pts[:, 1:2]) ** 2 + (zs - pts[:, 2:3]) ** 2
    sel = npts.exact_k_min(torch.where(valid, d2, torch.full_like(d2, _INVALID_DIST2)), M)
    lidx_m = torch.gather(lidx, 1, sel)
    ok = lidx_m < L
    far_m = torch.full_like(sel, 1e5, dtype=xs.dtype)
    return CandCache(xs=torch.where(ok, torch.gather(xs, 1, sel), far_m),
                     ys=torch.where(ok, torch.gather(ys, 1, sel), far_m),
                     zs=torch.where(ok, torch.gather(zs, 1, sel), far_m),
                     lidx=torch.clamp(lidx_m, max=L))


def sdf_value_and_grad_cached(cache: CandCache, lm: npts.LocalMap, mc: npts.MapConfig,
                              decoder, sdf_scale: float, pts: torch.Tensor,
                              after_pgo: bool = False):
    """Re-rank the cached candidates at ``pts`` (exact top-k, lowest index
    first among ties, like ``lax.top_k``), gather the k winners' features
    (and quaternions after a pose-graph optimisation) and run the analytic
    core.  Returns (sdf, grad, nn_count, sdf_std)."""
    L = mc.local_capacity
    M = cache.lidx.shape[1]
    d2 = ((cache.xs - pts[:, 0:1]) ** 2 + (cache.ys - pts[:, 1:2]) ** 2
          + (cache.zs - pts[:, 2:3]) ** 2)
    valid_all = (cache.lidx < L) & (d2 <= mc.max_valid_dist2)
    nn_count = torch.sum(valid_all, dim=-1)
    d2 = torch.where(valid_all, d2, torch.full_like(d2, _INVALID_DIST2))
    k = min(mc.nn_k, M)
    sel = npts.exact_k_min(d2, k)
    valid = torch.gather(d2, 1, sel) < _INVALID_DIST2
    pos_k = torch.stack([torch.gather(a, 1, sel) for a in (cache.xs, cache.ys, cache.zs)], -1)
    lidx_k = torch.gather(cache.lidx, 1, sel)
    safe = torch.where(valid, torch.clamp(lidx_k, max=L), torch.full_like(lidx_k, L))
    feats = lm.geo_features[safe]
    quat = lm.attr_rows[safe][..., npts.C_QUAT] if after_pgo else None
    layers = decoder.layers()
    if mc.weighted_first:
        sdf, grad = _core(mc, layers, sdf_scale, pts, pos_k, quat, feats, valid)
        sdf_std = torch.zeros_like(sdf)
    else:
        sdf, grad, sdf_std = _core_pn(mc, layers, sdf_scale, pts, pos_k, quat, feats, valid)
    return sdf, grad, nn_count, sdf_std
