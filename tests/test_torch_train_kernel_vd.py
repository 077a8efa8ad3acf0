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
        for per in ((1 if wf else k), 6 * (1 if wf else k)):
            for n in (1, 37, 1638, 16384):
                R = ttk.general_rows_per_block(n, per, 132)
                assert 1 <= R and R * per <= ttk.GEN_DMAX
                assert -(-n // R) * R >= n
