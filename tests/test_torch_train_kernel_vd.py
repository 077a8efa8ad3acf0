"""The training-iteration and eikonal kernels' plain twins at offset widths
VD > 3 (positional encoding: NeRF bands 2 and 4 give VD 15 and 27, Gaussian
Fourier features of 16 bands VD 35) against the JAX package's Pallas
kernels in interpret mode, which take VD as a parameter, at k = 6 in both
interpolation modes; and the packed decoder's width arithmetic the CUDA
wrappers use to pick the kernels' VD = 3 build or their general form.

Tolerances as in tests/test_torch_train_kernel.py: per-row outputs (dfeats)
rtol 1e-5 / atol 1e-6; the loss and the decoder gradients (batch sums in
another order) within 1e-5 of the largest |value| among the reference's
decoder gradients."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import np_

from pin_slam_torch.ops import train_kernel as ttk
from pin_slam_tpu.ops import train_kernel as jtk

torch.set_num_threads(1)
F, H = 8, 64
C = F + 1


def _decoder(rng, vd):
    return (rng.normal(size=(F + vd, H)).astype(np.float32) * 0.3,
            rng.normal(size=H).astype(np.float32) * 0.1,
            rng.normal(size=(H, 1)).astype(np.float32) * 0.3,
            np.float32(rng.normal() * 0.1))


def _pack(W1, b1, W2, b2):
    return torch.as_tensor(np.concatenate([W1.ravel(), b1, W2.ravel(), [b2]]).astype(np.float32))


def _close_sum(got, ref, what, scale):
    ref = np.asarray(ref, np.float64)
    assert np.abs(np.asarray(got, np.float64) - ref).max() <= 1e-5 * scale, what


def _check(out, loss, dfeats, dW1, db1, dW2, db2, B, k, vd):
    t_loss, t_df, t_gp = (np_(x) for x in out)
    np.testing.assert_allclose(t_df, np.asarray(dfeats).reshape(B, k, C), rtol=1e-5, atol=1e-6)
    n1 = (F + vd) * H
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in (dW1, db1, dW2, db2))
    _close_sum(t_loss, loss, "loss", max(gmax, abs(float(loss))))
    _close_sum(t_gp[:n1].reshape(F + vd, H), dW1, "dW1", gmax)
    _close_sum(t_gp[n1:n1 + H], db1, "db1", gmax)
    _close_sum(t_gp[n1 + H:n1 + 2 * H].reshape(H, 1), dW2, "dW2", gmax)
    _close_sum(t_gp[-1], db2, "db2", gmax)


@pytest.mark.parametrize("vd", [15, 27, 35])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_train_twin_matches_pallas_at_vd(wf, vd):
    B, k, sigma, scale = 40, 6, 0.1, 0.055
    rng = np.random.default_rng(30 + vd)
    feats = rng.standard_normal((B, k * C)).astype(np.float32)
    w = rng.random((B, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    w[:5, 3:] = 0.0
    vec = (rng.standard_normal((B, vd if wf else k * vd)) * 0.2).astype(np.float32)
    label = (rng.standard_normal(B) * 0.3).astype(np.float32)
    wt = (rng.random(B) * (rng.random(B) > 0.1) / B).astype(np.float32)
    W = _decoder(rng, vd)
    cfg = jtk.TrainKernelConfig(B=B, k=k, F=F, VD=vd, H=H, sigma=sigma, scale=scale,
                                weighted_first=wf, tiles=5)
    ref = jtk.fused_train_iter(cfg, *(jnp.asarray(a) for a in (feats, w, vec, label, wt)),
                               *(jnp.asarray(a) for a in W), interpret=True)
    out = ttk.train_iter(torch.as_tensor(feats).view(B, k, C), torch.as_tensor(w),
                         torch.as_tensor(vec), torch.as_tensor(label), torch.as_tensor(wt),
                         _pack(*W), wf, scale, sigma)
    _check(out, *ref, B=B, k=k, vd=vd)


@pytest.mark.parametrize("vd", [15, 27, 35])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_eikonal_twin_matches_pallas_at_vd(wf, vd):
    n, k, scale, step = 37, 6, 0.055, 0.06
    rng = np.random.default_rng(50 + vd)
    feats = rng.standard_normal((n, k * C)).astype(np.float32)
    wst = rng.random((6 * n, k)).astype(np.float32)
    wst /= wst.sum(1, keepdims=True)
    vst = (rng.standard_normal((6 * n, vd if wf else k * vd)) * 0.2).astype(np.float32)
    esc = (rng.random(n) * (rng.random(n) > 0.1) * 0.5 / n).astype(np.float32)
    W = _decoder(rng, vd)
    cfg = jtk.EikKernelConfig(n=n, k=k, F=F, VD=vd, H=H, scale=scale, step=step,
                              weighted_first=wf)
    ref = jtk.fused_eikonal_iter(cfg, *(jnp.asarray(a) for a in (feats, wst, vst, esc)),
                                 *(jnp.asarray(a) for a in W), interpret=True)
    out = ttk.eikonal_iter(torch.as_tensor(feats).view(n, k, C), torch.as_tensor(wst),
                           torch.as_tensor(vst), torch.as_tensor(esc), _pack(*W), wf, scale,
                           step)
    _check(out, *ref, B=n, k=k, vd=vd)


@pytest.mark.parametrize("vd", [3, 9, 27, 35, ttk.MAX_VD])
def test_packed_width_round_trips(vd):
    """n_params and offset_width invert each other: the wrappers read VD off
    the packed decoder to pick the VD = 3 build or the general form."""
    p = torch.zeros(ttk.n_params(vd))
    assert ttk.offset_width(p) == vd
    assert ttk.n_params(vd) == (F + vd) * H + 2 * H + 1


@pytest.mark.parametrize("wf", [True, False])
def test_general_rows_per_block_cover_every_shape(wf):
    """The general form's rows per block: every (n, k) fits a block's decode
    budget and every row is covered, for the train kernel (1 or k decodes a
    row) and the eikonal kernel (6 or 6k)."""
    for k in range(1, ttk.MAX_K + 1):
        for per, staged in (((1 if wf else k), wf), (6 * (1 if wf else k), True)):
            for n in (1, 37, 1638, 16384):
                R = ttk.general_rows_per_block(n, per, k, staged, 132)
                assert 1 <= R and R * per <= ttk.GEN_DMAX
                assert -(-n // R) * R >= n


def test_general_width_classes():
    """Every VD in 1..64 but 3 (the VD = 3 build's) maps to exactly one of
    the general forms' builds, the narrowest whose padded input width holds
    its 8 + VD inputs; the widths in use (NeRF bands 1, 2, 4: VD 9, 15, 27;
    Gaussian 16 bands: VD 35) each have a build at most 7 wider."""
    assert ttk.GEN_WIDTHS == tuple(sorted(ttk.GEN_WIDTHS))
    for vd in range(1, ttk.MAX_VD + 1):
        if vd == ttk.KERNEL_VD:
            continue
        w = ttk.general_width(vd)
        fits = [x for x in ttk.GEN_WIDTHS if x >= F + vd]
        assert w == fits[0] and w in ttk.GEN_WIDTHS
        assert w % 4 == 0                  # whole float4s of inputs
    for vd in (9, 15, 27, 35):
        assert ttk.general_width(vd) - (F + vd) <= 7
    assert ttk.general_width(ttk.MAX_VD) == F + ttk.MAX_VD
    for bad in (0, ttk.MAX_VD + 1):
        with pytest.raises(ValueError):
            ttk.general_width(bad)


@pytest.mark.parametrize("resident", [1, 132, 264, 528])
@pytest.mark.parametrize("kernel", ["train_iter", "eikonal"])
def test_general_rows_per_block_under_residency(kernel, resident):
    """The rows-per-block rule at a given residency: every (n, k, mode) is
    covered within the block's budget (decodes at most GEN_DMAX; a staged
    block's k feature rows at most GEN_STAGE floats), and R is the smallest
    of the budget's rows with the least cost, ceil(blocks / resident) x
    (tiles + the fixed tiles) -- so a launch that fits in one wave of
    resident blocks is not given fewer, larger blocks."""
    for k in range(1, ttk.MAX_K + 1):
        for wf in (True, False):
            if kernel == "train_iter":
                per, staged = (1 if wf else k), wf
            else:
                per, staged = 6 * (1 if wf else k), True
            cap = ttk.general_max_rows(per, k, staged)
            assert cap >= 1 and cap * per <= ttk.GEN_DMAX
            if staged:
                assert cap * k * C <= ttk.GEN_STAGE
            for n in (1, 7, 37, 819, 1638, 10000, 16384):
                R = ttk.general_rows_per_block(n, per, k, staged, resident)
                assert 1 <= R <= cap and -(-n // R) * R >= n

                def cost(r):
                    return (-(-(-(-n // r)) // resident)
                            * (-(-(r * per) // ttk.GEN_TILE) + ttk.GEN_BLOCK_TILES))

                best = min(cost(r) for r in range(1, cap + 1))
                assert cost(R) == best
                assert all(cost(r) > best for r in range(1, R))


def test_general_rows_per_block_paths():
    """The launches the paths make at 2 blocks an SM on 132 SMs (264
    resident): path H's train kernel (B 16384, k 6 per neighbour) three
    waves of 21-row blocks, its eikonal kernel (n 1638, 36 decodes a row)
    three-row blocks; pe_gaussian's (weighted_first) one wave each."""
    assert ttk.general_rows_per_block(16384, 6, 6, False, 264) == 21
    assert ttk.general_rows_per_block(1638, 36, 6, True, 264) == 3
    R = ttk.general_rows_per_block(16384, 1, 6, True, 264)
    assert -(-16384 // R) <= 264 and R <= ttk.GEN_TILE
    R = ttk.general_rows_per_block(1638, 6, 6, True, 264)
    assert -(-1638 // R) <= 264 and R * 6 <= ttk.GEN_TILE
