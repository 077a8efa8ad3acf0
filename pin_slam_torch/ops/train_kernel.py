"""The mapping loop's per-iteration math: the CUDA kernels
``csrc/train_iter.cu`` / ``csrc/eikonal.cu`` and their plain PyTorch twins.
Counterpart of ``pin_slam_tpu/ops/train_kernel.py``.

Both functions take the gathered feature rows (B, k, F+1) (column F is the
certainty channel), the per-row geometry, and the one-hidden-layer decoder
as ONE packed vector [W1 (in,H) | b1 | W2 (H,1) | b2] (models/decoder.py),
and return (loss (), dfeats (B, k, F+1), dparams (like the packed vector)).
dfeats' certainty column carries the row's IDW weight (train) or the sum of
its six stencil weights (eikonal): the same scatter-add that delivers the
feature gradients then accumulates the certainty, as in the JAX package.

The plain twins compute the loss with torch ops and the gradients with
``torch.autograd.grad``: an independent check of the kernels' hand-derived
backward.  Unlike the JAX kernels (which break at k = 8), both the kernels
and the twins take any k up to 16.
"""

from __future__ import annotations

import torch

from pin_slam_torch.models.decoder import unpack
from pin_slam_torch.ops import _cuda

KERNEL_F, KERNEL_VD, KERNEL_H = 8, 3, 64   # the shapes the CUDA kernels are built for
MAX_K = 16


def _mlp(x, W1, b1, W2, b2):
    return (torch.relu(x @ W1 + b1) @ W2)[..., 0] + b2[0]


def _bce(pred, label, sigma):
    z = pred / sigma
    tgt = torch.sigmoid(label / sigma)
    return torch.clamp(z, min=0.0) - z * tgt + torch.log1p(torch.exp(-torch.abs(z)))


def train_iter_plain(feats, w, vin, label, wt, params, weighted_first: bool,
                     scale: float, sigma: float):
    B, k, C = feats.shape
    F = C - 1
    VD = vin.shape[-1] if weighted_first else vin.shape[-1] // k
    H = (params.shape[0] - 1) // (F + VD + 2)
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        p = params.detach().requires_grad_(True)
        W1, b1, W2, b2 = unpack(p, F + VD, H)
        if weighted_first:
            gf = torch.einsum("bk,bkf->bf", w, f[..., :F])
            pred = _mlp(torch.cat([gf, vin], 1), W1, b1, W2, b2) * scale
        else:
            xin = torch.cat([f[..., :F], vin.reshape(B, k, VD)], -1)
            pred = torch.sum(_mlp(xin, W1, b1, W2, b2) * w, dim=1) * scale
        loss = torch.sum(_bce(pred, label, sigma) * wt)
        cert = torch.sum(w * f[..., F])          # d/d f[..., F] = w
        gf_, gp_ = torch.autograd.grad(loss + cert, [f, p])
    return loss.detach(), gf_, gp_


def eikonal_iter_plain(feats, wst, vst, esc, params, weighted_first: bool,
                       scale: float, step: float):
    n, k, C = feats.shape
    F = C - 1
    VD = vst.shape[-1] if weighted_first else vst.shape[-1] // k
    H = (params.shape[0] - 1) // (F + VD + 2)
    w3 = wst.reshape(6, n, k)
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        p = params.detach().requires_grad_(True)
        W1, b1, W2, b2 = unpack(p, F + VD, H)
        if weighted_first:
            stf = torch.einsum("jnk,nkf->jnf", w3, f[..., :F]).reshape(6 * n, F)
            sdf = (_mlp(torch.cat([stf, vst], 1), W1, b1, W2, b2) * scale).reshape(6, n)
        else:
            xin = torch.cat([f[None, :, :, :F].expand(6, n, k, F),
                             vst.reshape(6, n, k, VD)], -1)
            sdf = torch.sum(_mlp(xin, W1, b1, W2, b2) * w3, dim=-1) * scale
        g = torch.stack([sdf[0] - sdf[3], sdf[1] - sdf[4], sdf[2] - sdf[5]], -1) / (2.0 * step)
        norm = torch.sqrt(torch.sum(g * g, -1) + 1e-12)
        loss = torch.sum((norm - 1.0) ** 2 * esc)
        cert = torch.einsum("jnk,nk->", w3, f[..., F])   # d/d f[..., F] = sum_j wst
        gf_, gp_ = torch.autograd.grad(loss + cert, [f, p])
    return loss.detach(), gf_, gp_


def _check(feats, params, k, weighted_first, vcols, rows_of, *tensors):
    """Input checks shared by the CPU and CUDA paths (so the CPU tests catch
    what the kernels would refuse); the kernels' build shapes on CUDA only.
    ``rows_of``: (tensor, expected leading dim) pairs."""
    if not (1 <= k <= MAX_K) or feats.dim() != 3 or feats.shape[1] != k:
        raise ValueError(f"feats {tuple(feats.shape)} for k={k} (k <= {MAX_K})")
    for t in (feats, params) + tensors:
        if t.device != feats.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("training kernels take contiguous float32 tensors on one device")
    for t, rows in rows_of:
        if t.shape[0] != rows:
            raise ValueError(f"row count mismatch: {tuple(t.shape)} vs {rows}")
    vd = vcols if weighted_first else vcols // k
    if feats.device.type == "cuda":
        n_par = (KERNEL_F + KERNEL_VD) * KERNEL_H + 2 * KERNEL_H + 1
        if feats.shape[2] != KERNEL_F + 1 or vd != KERNEL_VD or params.shape != (n_par,):
            raise NotImplementedError(
                f"the CUDA training kernels are built for F={KERNEL_F}, VD={KERNEL_VD}, "
                f"H={KERNEL_H}; got feats {tuple(feats.shape)}, {params.shape[0]} decoder values")


def _launch_outputs(rows, k, dev):
    nblocks = (rows + 63) // 64
    E = (KERNEL_F + KERNEL_VD) * KERNEL_H + 2 * KERNEL_H + 2
    return (torch.empty((rows, k, KERNEL_F + 1), dtype=torch.float32, device=dev),
            torch.empty((max(nblocks, 1), E), dtype=torch.float32, device=dev),
            torch.empty((E,), dtype=torch.float32, device=dev))


def train_iter(feats, w, vin, label, wt, params, weighted_first: bool,
               scale: float, sigma: float):
    """feats (B,k,F+1); w (B,k) (invalid zeroed); vin (B,VD) blended offset
    vector (weighted_first) or (B,k*VD) per-neighbour vectors; label (B,);
    wt (B,) premultiplied ``weight * in_pool / denom``."""
    B, k = w.shape
    _check(feats, params, k, weighted_first, vin.shape[1],
           [(t, B) for t in (feats, vin, label, wt)], w, vin, label, wt)
    if feats.device.type == "cpu":
        return train_iter_plain(feats, w, vin, label, wt, params, weighted_first,
                                scale, sigma)
    dev = feats.device
    dfeats, partial, out = _launch_outputs(B, k, dev)
    f = _cuda.fn("train_iter", "train_iter_launch",
                 [_cuda.P] * 6 + [_cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
                 + [_cuda.P] * 4)
    _cuda.check(f(feats.data_ptr(), w.data_ptr(), vin.data_ptr(), label.data_ptr(),
                  wt.data_ptr(), params.data_ptr(), B, k, int(weighted_first),
                  float(scale), float(1.0 / sigma), dfeats.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), _cuda.stream_ptr(dev)),
                "train_iter_kernel")
    _cuda.COUNTS["train_iter"] += 1
    return out[-1], dfeats, out[:-1]


def eikonal_iter(feats, wst, vst, esc, params, weighted_first: bool,
                 scale: float, step: float):
    """feats (n,k,F+1) base rows; wst (6n,k) stencil IDW weights (stencil j
    in rows [j*n, (j+1)*n)); vst (6n,VD) or (6n,k*VD); esc (n,)
    premultiplied ``weight_e * in_pool / denom``."""
    n, k = feats.shape[0], feats.shape[1]
    _check(feats, params, k, weighted_first, vst.shape[1],
           [(esc, n), (wst, 6 * n), (vst, 6 * n)], wst, vst, esc)
    if wst.shape[1] != k:
        raise ValueError(f"wst {tuple(wst.shape)} for k={k}")
    if feats.device.type == "cpu":
        return eikonal_iter_plain(feats, wst, vst, esc, params, weighted_first,
                                  scale, step)
    dev = feats.device
    dfeats, partial, out = _launch_outputs(n, k, dev)
    f = _cuda.fn("eikonal", "eikonal_launch",
                 [_cuda.P] * 5 + [_cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
                 + [_cuda.P] * 4)
    _cuda.check(f(feats.data_ptr(), wst.data_ptr(), vst.data_ptr(), esc.data_ptr(),
                  params.data_ptr(), n, k, int(weighted_first), float(scale),
                  float(1.0 / (2.0 * step)), dfeats.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), _cuda.stream_ptr(dev)), "eikonal_kernel")
    _cuda.COUNTS["eikonal"] += 1
    return out[-1], dfeats, out[:-1]
