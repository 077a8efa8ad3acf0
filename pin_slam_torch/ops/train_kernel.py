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

import ctypes
import functools

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
    dev = feats.get_device()               # an int: no torch.device built per tensor
    for t in (feats, params) + tensors:
        if t.get_device() != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("training kernels take contiguous float32 tensors on one device")
    for t, rows in rows_of:
        if t.shape[0] != rows:
            raise ValueError(f"row count mismatch: {tuple(t.shape)} vs {rows}")
    vd = vcols if weighted_first else vcols // k
    if feats.is_cuda:
        n_par = (KERNEL_F + KERNEL_VD) * KERNEL_H + 2 * KERNEL_H + 1
        if feats.shape[2] != KERNEL_F + 1 or vd != KERNEL_VD or params.shape != (n_par,):
            raise NotImplementedError(
                f"the CUDA training kernels are built for F={KERNEL_F}, VD={KERNEL_VD}, "
                f"H={KERNEL_H}; got feats {tuple(feats.shape)}, {params.shape[0]} decoder values")


TRAIN_THREADS = 128   # threads per block of csrc/train_iter.cu
TRAIN_SLOTS = 16      # decodes per pass: 8 groups of 16 lanes, two decodes each
TRAIN_DMAX = 1024     # decodes, and rows x k, per block
TRAIN_BLOCK_PASSES = 8   # a block's fixed work (weights, staging, sums), in passes
_TRAIN_ARGS = ([_cuda.P] * 6 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
               + [_cuda.P] * 4)
_E = (KERNEL_F + KERNEL_VD) * KERNEL_H + 2 * KERNEL_H + 2   # a block's partial row
_TRAIN_RESIDENT = {}


@functools.lru_cache(maxsize=None)
def _rows_per_block(n: int, decodes_per_row: int, max_rows: int, slots: int, resident: int,
                    fixed: int = 0) -> int:
    """Rows R per block of a kernel that runs a block's R * decodes_per_row
    decodes in passes of ``slots``, plus ``fixed`` passes of its own work,
    with ``resident`` blocks running at once.  R (at most ``max_rows``)
    minimises the busiest resident slot's work, ceil(blocks / resident) *
    (passes + fixed) (the smallest such R, for the most blocks)."""
    best, best_r = None, 1
    for r in range(1, max_rows + 1):
        blocks = -(-n // r)
        cost = -(-blocks // resident) * (-(-(r * decodes_per_row) // slots) + fixed)
        if best is None or cost < best:
            best, best_r = cost, r
        if blocks <= 1:
            break
    return best_r


def train_rows_per_block(B: int, k: int, weighted_first: bool, resident: int) -> int:
    """Rows R per block of the train kernel: R (or R * k) decodes in passes
    of ``TRAIN_SLOTS`` plus a fixed ``TRAIN_BLOCK_PASSES``, R * k staged rows
    at most ``TRAIN_DMAX``; ``resident`` blocks run at once (SMs x blocks per
    SM)."""
    return _rows_per_block(B, 1 if weighted_first else k, TRAIN_DMAX // k, TRAIN_SLOTS,
                           resident, TRAIN_BLOCK_PASSES)


def train_resident_blocks(device: int, weighted_first: bool) -> int:
    """Blocks of the train kernel that ``device`` holds at once, as the
    build's registers allow (cached).  The first call also checks that the
    build's block geometry is the one ``train_rows_per_block`` assumes."""
    key = (device, weighted_first)
    n = _TRAIN_RESIDENT.get(key)
    if n is None:
        geom = (ctypes.c_int * 3)()
        _cuda.lib("train_iter").train_iter_geometry(geom)
        if tuple(geom) != (TRAIN_THREADS, TRAIN_SLOTS, TRAIN_DMAX):
            raise RuntimeError(f"csrc/train_iter.cu's block geometry {tuple(geom)} is not "
                               f"({TRAIN_THREADS}, {TRAIN_SLOTS}, {TRAIN_DMAX})")
        per = _cuda.fn("train_iter", "train_iter_blocks_per_sm", [_cuda.I])(int(weighted_first))
        if per < 1:
            raise RuntimeError(f"occupancy query of train_iter_kernel failed ({per})")
        n = _TRAIN_RESIDENT[key] = _cuda.sm_count(device) * per
    return n


def train_iter(feats, w, vin, label, wt, params, weighted_first: bool,
               scale: float, sigma: float):
    """feats (B,k,F+1); w (B,k) (invalid zeroed); vin (B,VD) blended offset
    vector (weighted_first) or (B,k*VD) per-neighbour vectors; label (B,);
    wt (B,) premultiplied ``weight * in_pool / denom``."""
    B, k = w.shape
    _check(feats, params, k, weighted_first, vin.shape[1],
           [(t, B) for t in (feats, vin, label, wt)], w, vin, label, wt)
    if feats.is_cpu:
        return train_iter_plain(feats, w, vin, label, wt, params, weighted_first,
                                scale, sigma)
    dev = feats.get_device()
    nf = B * k * (KERNEL_F + 1)
    if B == 0:                                   # nothing to launch
        out = feats.new_zeros((_E,))
        return out[-1], feats.new_empty((0, k, KERNEL_F + 1)), out[:-1]
    wf = bool(weighted_first)
    R = train_rows_per_block(B, k, wf, train_resident_blocks(dev, wf))
    nblocks = -(-B // R)
    buf = feats.new_empty((nf + (nblocks + 1) * _E,))     # dfeats | out | block partials
    dfeats, out = buf[:nf].view(B, k, KERNEL_F + 1), buf[nf:nf + _E]
    f = _cuda.fn("train_iter", "train_iter_launch", _TRAIN_ARGS)
    _cuda.check(f(feats.data_ptr(), w.data_ptr(), vin.data_ptr(), label.data_ptr(),
                  wt.data_ptr(), params.data_ptr(), B, k, int(wf), R, float(scale),
                  float(1.0 / sigma), dfeats.data_ptr(), out.data_ptr() + 4 * _E,
                  out.data_ptr(), _cuda.stream_ptr(dev)), "train_iter_kernel")
    _cuda.COUNTS["train_iter"] += 1
    return out[-1], dfeats, out[:-1]


EIK_SLOTS = 64     # decodes per chunk of csrc/eikonal.cu (256 threads, 4 lanes a decode)
EIK_DMAX = 512     # decodes per block
_EIK_ARGS = ([_cuda.P] * 5 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
             + [_cuda.P] * 4)


def eikonal_rows_per_block(n: int, k: int, weighted_first: bool, n_sms: int) -> int:
    """Base rows R per block of the eikonal kernel: R * (6 or 6k) decodes,
    at most ``EIK_DMAX``, in chunks of ``EIK_SLOTS``, one block an SM at a
    time."""
    dr = 6 * (1 if weighted_first else k)
    return _rows_per_block(n, dr, EIK_DMAX // dr, EIK_SLOTS, n_sms)


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
    if feats.is_cpu:
        return eikonal_iter_plain(feats, wst, vst, esc, params, weighted_first,
                                  scale, step)
    dev = feats.get_device()
    R = eikonal_rows_per_block(n, k, bool(weighted_first), _cuda.sm_count(dev))
    nblocks = -(-n // R)
    nf = n * k * (KERNEL_F + 1)
    buf = feats.new_empty((nf + (nblocks + 1) * _E,))     # dfeats | out | block partials
    dfeats, out = buf[:nf].view(n, k, KERNEL_F + 1), buf[nf:nf + _E]
    f = _cuda.fn("eikonal", "eikonal_launch", _EIK_ARGS)
    _cuda.check(f(feats.data_ptr(), wst.data_ptr(), vst.data_ptr(), esc.data_ptr(),
                  params.data_ptr(), n, k, int(weighted_first), R, float(scale),
                  float(1.0 / (2.0 * step)), dfeats.data_ptr(), out.data_ptr() + 4 * _E,
                  out.data_ptr(), _cuda.stream_ptr(dev)), "eikonal_kernel")
    _cuda.COUNTS["eikonal"] += 1
    return out[-1], dfeats, out[:-1]
