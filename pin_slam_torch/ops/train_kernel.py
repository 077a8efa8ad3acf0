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

The offset vector's width VD is 3 without positional encoding: the kernels
built for it (``train_iter_launch`` / ``eikonal_launch``) stay as they are.
With encoding (any other VD up to ``MAX_VD``) the same wrappers launch the
kernels' general forms (``*_launch_vd``, csrc/train_common.cuh ``gen``),
built once for each padded input width in ``GEN_WIDTHS`` (``general_width``)
and taking VD at run time; rows per block come from that build's residency
(``general_resident_blocks``, ``general_rows_per_block``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pin_slam_torch.models.decoder import unpack
from pin_slam_torch.ops import _cuda

KERNEL_F, KERNEL_VD, KERNEL_H = 8, 3, 64   # the shapes the CUDA kernels are built for
MAX_K = 16
MAX_VD = 64                                # the general forms' widest offset vector


def n_params(vd: int) -> int:
    """Length of the packed decoder at offset width ``vd``."""
    return (KERNEL_F + vd) * KERNEL_H + 2 * KERNEL_H + 1


def offset_width(params: torch.Tensor, F: int = KERNEL_F, H: int = KERNEL_H) -> int:
    """VD of a packed one-hidden-layer decoder with F features and H units."""
    return (params.shape[0] - 1 - 2 * H) // H - F


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
        if (feats.shape[2] != KERNEL_F + 1 or not 1 <= vd <= MAX_VD
                or params.shape != (n_params(vd),)):
            raise NotImplementedError(
                f"the CUDA training kernels take F={KERNEL_F}, H={KERNEL_H} and VD up to "
                f"{MAX_VD}; got feats {tuple(feats.shape)}, VD {vd}, {params.shape[0]} "
                f"decoder values")
    return vd


TRAIN_THREADS = 128   # threads per block of csrc/train_iter.cu
TRAIN_SLOTS = 16      # decodes per pass: 8 groups of 16 lanes, two decodes each
TRAIN_DMAX = 1024     # decodes, and rows x k, per block
TRAIN_BLOCK_PASSES = 8   # a block's fixed work (weights, staging, sums), in passes
_TRAIN_ARGS = ([_cuda.P] * 6 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
               + [_cuda.P] * 4)
_TRAIN_ARGS_VD = ([_cuda.P] * 6 + [_cuda.I] * 6 + [_cuda.F, _cuda.F] + [_cuda.P] * 4)
_TRAIN_RESIDENT = {}
# the general forms' block geometry (csrc/train_common.cuh gen): threads, decodes
# per forward tile, decodes per block, floats of the block's row staging
GEN_THREADS, GEN_TILE, GEN_DMAX = 256, 64, 128
GEN_STAGE = GEN_DMAX * (KERNEL_H + 4)
GEN_WIDTHS = (16, 24, 36, 48, 72)   # padded input widths F + VD of the builds
GEN_BLOCK_TILES = 1                  # a block's fixed work (decoder, sums), in tiles
_GEN_RESIDENT = {}


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


def general_width(vd: int) -> int:
    """The padded input width of the general form's build that takes offset
    width ``vd``: the narrowest of ``GEN_WIDTHS`` holding F + VD inputs."""
    if not 1 <= vd <= MAX_VD:
        raise ValueError(f"the general forms take VD in [1, {MAX_VD}], not {vd}")
    return next(w for w in GEN_WIDTHS if w >= KERNEL_F + vd)


def general_max_rows(decodes_per_row: int, k: int, staged: bool) -> int:
    """The most rows a general-form block takes: its decodes at most
    ``GEN_DMAX`` and, where it stages its rows' k feature rows (the train
    kernel with weighted_first, the eikonal kernel), those at most
    ``GEN_STAGE`` floats."""
    r = GEN_DMAX // decodes_per_row
    return min(r, GEN_STAGE // (k * (KERNEL_F + 1))) if staged else r


def general_rows_per_block(n: int, decodes_per_row: int, k: int, staged: bool,
                           resident: int) -> int:
    """Rows R a general-form block takes at a time (VD != 3): a group of R
    rows, R * decodes_per_row decodes in tiles of ``GEN_TILE`` plus
    ``GEN_BLOCK_TILES`` of fixed work, within the block's budget
    (``general_max_rows``); ``resident`` blocks run at once (SMs x blocks per
    SM of the build that runs), and the launch has at most that many blocks,
    each taking groups in turn.  The train kernel has 1 or k decodes a row
    and stages its rows with weighted_first; the eikonal kernel 6 or 6k and
    always stages them."""
    return _rows_per_block(n, decodes_per_row, general_max_rows(decodes_per_row, k, staged),
                           GEN_TILE, resident, GEN_BLOCK_TILES)


def _general_geometry() -> None:
    """Raise unless csrc/train_iter.cu's general form has the block geometry,
    the widest VD and the width classes these wrappers assume (checked
    once)."""
    if not _GEN_CHECKED:
        geom = (ctypes.c_int * 5)()
        lib = _cuda.lib("train_iter")
        lib.train_iter_general_geometry(geom)
        want = (GEN_THREADS, GEN_TILE, GEN_DMAX, GEN_STAGE, MAX_VD)
        if tuple(geom) != want:
            raise RuntimeError(f"csrc/train_iter.cu's general geometry {tuple(geom)} is not "
                               f"{want}")
        for vd in range(1, MAX_VD + 1):
            if lib.train_iter_general_width(vd) != general_width(vd):
                raise RuntimeError(f"csrc/train_iter.cu builds VD {vd} at width "
                                   f"{lib.train_iter_general_width(vd)}, not "
                                   f"{general_width(vd)}")
        _GEN_CHECKED.append(True)


_GEN_CHECKED = []


def general_resident_blocks(kernel: str, device: int, weighted_first: bool, vd: int) -> int:
    """Blocks of the general form of ``kernel`` ("train_iter" or "eikonal")
    that ``device`` holds at once in the build for ``vd``, as its registers
    and its most shared memory allow (cached).  The first call also checks
    the build's geometry."""
    key = (kernel, device, bool(weighted_first), general_width(vd))
    n = _GEN_RESIDENT.get(key)
    if n is None:
        _general_geometry()
        per = _cuda.fn(kernel, f"{kernel}_general_blocks_per_sm",
                       [_cuda.I, _cuda.I])(int(weighted_first), vd)
        if per < 1:
            raise RuntimeError(f"occupancy query of {kernel}_general_kernel at VD {vd} "
                               f"failed ({per})")
        n = _GEN_RESIDENT[key] = _cuda.sm_count(device) * per
    return n


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
    vd = _check(feats, params, k, weighted_first, vin.shape[1],
                [(t, B) for t in (feats, vin, label, wt)], w, vin, label, wt)
    if feats.is_cpu:
        return train_iter_plain(feats, w, vin, label, wt, params, weighted_first,
                                scale, sigma)
    dev = feats.get_device()
    nf = B * k * (KERNEL_F + 1)
    ne = n_params(vd) + 1
    if B == 0:                                   # nothing to launch
        out = feats.new_zeros((ne,))
        return out[-1], feats.new_empty((0, k, KERNEL_F + 1)), out[:-1]
    wf = bool(weighted_first)
    general = vd != KERNEL_VD
    if general:
        grid = general_resident_blocks("train_iter", dev, wf, vd)
        R = general_rows_per_block(B, 1 if wf else k, k, wf, grid)
        nblocks = min(-(-B // R), grid)          # blocks take groups of R rows in turn
    else:
        R = train_rows_per_block(B, k, wf, train_resident_blocks(dev, wf))
        nblocks = -(-B // R)
    buf = feats.new_empty((nf + (nblocks + 1) * ne,))     # dfeats | out | block partials
    dfeats, out = buf[:nf].view(B, k, KERNEL_F + 1), buf[nf:nf + ne]
    f = _cuda.fn("train_iter", "train_iter_launch_vd" if general else "train_iter_launch",
                 _TRAIN_ARGS_VD if general else _TRAIN_ARGS)
    _cuda.check(f(feats.data_ptr(), w.data_ptr(), vin.data_ptr(), label.data_ptr(),
                  wt.data_ptr(), params.data_ptr(),
                  *((B, k, vd, int(wf), R, nblocks) if general else (B, k, int(wf), R)),
                  float(scale), float(1.0 / sigma), dfeats.data_ptr(), out.data_ptr() + 4 * ne,
                  out.data_ptr(), _cuda.stream_ptr(dev)),
                "train_iter_general_kernel" if general else "train_iter_kernel")
    _cuda.COUNTS["train_iter"] += 1
    return out[-1], dfeats, out[:-1]


EIK_SLOTS = 64     # decodes per chunk of csrc/eikonal.cu (256 threads, 4 lanes a decode)
EIK_DMAX = 512     # decodes per block
_EIK_ARGS = ([_cuda.P] * 5 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.F]
             + [_cuda.P] * 4)
_EIK_ARGS_VD = ([_cuda.P] * 5 + [_cuda.I] * 6 + [_cuda.F, _cuda.F] + [_cuda.P] * 4)


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
    vd = _check(feats, params, k, weighted_first, vst.shape[1],
                [(esc, n), (wst, 6 * n), (vst, 6 * n)], wst, vst, esc)
    if wst.shape[1] != k:
        raise ValueError(f"wst {tuple(wst.shape)} for k={k}")
    if feats.is_cpu:
        return eikonal_iter_plain(feats, wst, vst, esc, params, weighted_first,
                                  scale, step)
    dev = feats.get_device()
    wf = bool(weighted_first)
    general = vd != KERNEL_VD
    if general:
        grid = general_resident_blocks("eikonal", dev, wf, vd)
        R = general_rows_per_block(n, 6 * (1 if wf else k), k, True, grid)
        nblocks = min(-(-n // R), grid)          # blocks take groups of R rows in turn
    else:
        R = eikonal_rows_per_block(n, k, wf, _cuda.sm_count(dev))
        nblocks = -(-n // R)
    nf, ne = n * k * (KERNEL_F + 1), n_params(vd) + 1
    buf = feats.new_empty((nf + (nblocks + 1) * ne,))     # dfeats | out | block partials
    dfeats, out = buf[:nf].view(n, k, KERNEL_F + 1), buf[nf:nf + ne]
    f = _cuda.fn("eikonal", "eikonal_launch_vd" if general else "eikonal_launch",
                 _EIK_ARGS_VD if general else _EIK_ARGS)
    _cuda.check(f(feats.data_ptr(), wst.data_ptr(), vst.data_ptr(), esc.data_ptr(),
                  params.data_ptr(),
                  *((n, k, vd, int(wf), R, max(nblocks, 1)) if general else (n, k, int(wf), R)),
                  float(scale), float(1.0 / (2.0 * step)), dfeats.data_ptr(),
                  out.data_ptr() + 4 * ne, out.data_ptr(), _cuda.stream_ptr(dev)),
                "eikonal_general_kernel" if general else "eikonal_kernel")
    _cuda.COUNTS["eikonal"] += 1
    return out[-1], dfeats, out[:-1]
