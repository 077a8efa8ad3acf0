"""The training-iteration and eikonal kernels' plain twins (autograd-based;
what pin_slam_torch runs on the CPU and what chip_smoke.py holds the CUDA
kernels against on the card) against the JAX package's Pallas kernels in
interpret mode at k = 6, in both interpolation modes, and against a JAX
autodiff reference at k = 8, which the Pallas kernels cannot run.

Tolerances: per-row outputs (dfeats) rtol 1e-5 / atol 1e-6 (same math per
row, different rounding order inside the 64-wide hidden layer); decoder
gradients and the loss are batch sums taken in a different order, so they
are compared relative to the largest |value| among the reference's decoder
gradients (1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

from pin_slam_torch.ops import train_kernel as ttk
from pin_slam_tpu.ops import train_kernel as jtk

torch.set_num_threads(1)
F, VD, H = 8, 3, 64
C = F + 1


def _decoder(rng):
    return (rng.normal(size=(F + VD, H)).astype(np.float32) * 0.3,
            rng.normal(size=H).astype(np.float32) * 0.1,
            rng.normal(size=(H, 1)).astype(np.float32) * 0.3,
            np.float32(rng.normal() * 0.1))


def _pack(W1, b1, W2, b2):
    return torch.as_tensor(np.concatenate([W1.ravel(), b1, W2.ravel(), [b2]]).astype(np.float32))


def _close_sum(got, ref, what, scale=None):
    ref = np.asarray(ref, np.float64)
    tol = 1e-5 * (np.abs(ref).max() if scale is None else scale)
    assert np.abs(np.asarray(got, np.float64) - ref).max() <= tol, what


def _check(out, loss, dfeats, dW1, db1, dW2, db2, B, k):
    t_loss, t_df, t_gp = (np_(x) for x in out)
    np.testing.assert_allclose(t_df, np.asarray(dfeats).reshape(B, k, C), rtol=1e-5, atol=1e-6)
    n1 = (F + VD) * H
    _close_sum(t_loss, loss, "loss")
    # decoder grads relative to the largest decoder-grad entry (the eikonal
    # db2 is a cancellation sum that is exactly 0 in exact arithmetic)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in (dW1, db1, dW2, db2))
    _close_sum(t_gp[:n1].reshape(F + VD, H), dW1, "dW1", gmax)
    _close_sum(t_gp[n1:n1 + H], db1, "db1", gmax)
    _close_sum(t_gp[n1 + H:n1 + 2 * H].reshape(H, 1), dW2, "dW2", gmax)
    _close_sum(t_gp[-1], db2, "db2", gmax)


def _train_inputs(rng, B, k, wf):
    feats = rng.standard_normal((B, k * C)).astype(np.float32)
    w = rng.random((B, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    w[:5, 3:] = 0.0                                   # rows with invalid neighbours
    vec = (rng.standard_normal((B, VD if wf else k * VD)) * 0.2).astype(np.float32)
    label = (rng.standard_normal(B) * 0.3).astype(np.float32)
    wt = (rng.random(B) * (rng.random(B) > 0.1) / B).astype(np.float32)
    return feats, w, vec, label, wt


def _eik_inputs(rng, n, k, wf):
    feats = rng.standard_normal((n, k * C)).astype(np.float32)
    wst = rng.random((6 * n, k)).astype(np.float32)
    wst /= wst.sum(1, keepdims=True)
    vst = (rng.standard_normal((6 * n, VD if wf else k * VD)) * 0.2).astype(np.float32)
    esc = (rng.random(n) * (rng.random(n) > 0.1) * 0.5 / n).astype(np.float32)
    return feats, wst, vst, esc


@pytest.mark.parametrize("wf", [True, False])
def test_train_iter_twin_matches_pallas(wf):
    B, k, sigma, scale = 256, 6, 0.1, 0.055
    rng = np.random.default_rng(3)
    feats, w, vec, label, wt = _train_inputs(rng, B, k, wf)
    W1, b1, W2, b2 = _decoder(rng)
    cfg = jtk.TrainKernelConfig(B=B, k=k, F=F, VD=VD, H=H, sigma=sigma, scale=scale,
                                weighted_first=wf, tiles=4)
    ref = jtk.fused_train_iter(cfg, *(jnp.asarray(a) for a in (feats, w, vec, label, wt)),
                               jnp.asarray(W1), jnp.asarray(b1), jnp.asarray(W2),
                               jnp.asarray(b2), interpret=True)
    out = ttk.train_iter(torch.as_tensor(feats).view(B, k, C), torch.as_tensor(w),
                         torch.as_tensor(vec), torch.as_tensor(label), torch.as_tensor(wt),
                         _pack(W1, b1, W2, b2), wf, scale, sigma)
    _check(out, *ref, B=B, k=k)


@pytest.mark.parametrize("wf", [True, False])
def test_eikonal_twin_matches_pallas(wf):
    n, k, scale, step = 64, 6, 0.055, 0.06
    rng = np.random.default_rng(5)
    feats, wst, vst, esc = _eik_inputs(rng, n, k, wf)
    W1, b1, W2, b2 = _decoder(rng)
    cfg = jtk.EikKernelConfig(n=n, k=k, F=F, VD=VD, H=H, scale=scale, step=step,
                              weighted_first=wf)
    ref = jtk.fused_eikonal_iter(cfg, *(jnp.asarray(a) for a in (feats, wst, vst, esc)),
                                 jnp.asarray(W1), jnp.asarray(b1), jnp.asarray(W2),
                                 jnp.asarray(b2), interpret=True)
    out = ttk.eikonal_iter(torch.as_tensor(feats).view(n, k, C), torch.as_tensor(wst),
                           torch.as_tensor(vst), torch.as_tensor(esc), _pack(W1, b1, W2, b2),
                           wf, scale, step)
    _check(out, *ref, B=n, k=k)


def _jax_ref_k8(kind, wf, arrays, W, scale, aux):
    """jax.value_and_grad over the same loss the kernels differentiate; any k."""
    def mlp(x, W1, b1, W2, b2):
        return (jax.nn.relu(x @ W1 + b1) @ W2)[..., 0] + b2

    def loss_fn(feats, W1, b1, W2, b2):
        if kind == "train":
            _, w, vec, label, wt = arrays
            B, k = w.shape
            f3 = feats.reshape(B, k, C)
            if wf:
                x = jnp.concatenate([jnp.einsum("bk,bkf->bf", w, f3[..., :F]), vec], 1)
                pred = mlp(x, W1, b1, W2, b2) * scale
            else:
                xin = jnp.concatenate([f3[..., :F], vec.reshape(B, k, VD)], -1)
                pred = jnp.sum(mlp(xin, W1, b1, W2, b2) * w, 1) * scale
            z, tgt = pred / aux, jax.nn.sigmoid(label / aux)
            loss = jnp.sum((jnp.maximum(z, 0) - z * tgt + jnp.log1p(jnp.exp(-jnp.abs(z)))) * wt)
            return loss + jnp.sum(w * f3[..., F]), loss
        _, wst, vst, esc = arrays
        n, k = esc.shape[0], wst.shape[1]
        f3, w3 = feats.reshape(n, k, C), wst.reshape(6, n, k)
        if wf:
            x = jnp.concatenate([jnp.einsum("jnk,nkf->jnf", w3, f3[..., :F]).reshape(6 * n, F),
                                 vst], 1)
            sdf = (mlp(x, W1, b1, W2, b2) * scale).reshape(6, n)
        else:
            xin = jnp.concatenate([jnp.broadcast_to(f3[None, ..., :F], (6, n, k, F)),
                                   vst.reshape(6, n, k, VD)], -1)
            sdf = jnp.sum(mlp(xin, W1, b1, W2, b2) * w3, -1) * scale
        g = jnp.stack([sdf[0] - sdf[3], sdf[1] - sdf[4], sdf[2] - sdf[5]], -1) / (2 * aux)
        loss = jnp.sum((jnp.sqrt(jnp.sum(g * g, -1) + 1e-12) - 1.0) ** 2 * esc)
        return loss + jnp.einsum("jnk,nk->", w3, f3[..., F]), loss

    (_, loss), g = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(arrays[0]), *(jnp.asarray(a) for a in W))
    return (loss,) + g


@pytest.mark.parametrize("kind", ["train", "eikonal"])
@pytest.mark.parametrize("wf", [True, False])
def test_twins_at_k8_match_jax_autodiff(kind, wf):
    rng = np.random.default_rng(8)
    k, scale = 8, 0.055
    W = _decoder(rng)
    if kind == "train":
        B = 192
        arrays = _train_inputs(rng, B, k, wf)
        out = ttk.train_iter(torch.as_tensor(arrays[0]).view(B, k, C),
                             *(torch.as_tensor(a) for a in arrays[1:]), _pack(*W), wf, scale, 0.1)
        ref = _jax_ref_k8(kind, wf, arrays, W, scale, 0.1)
    else:
        B = 48
        arrays = _eik_inputs(rng, B, k, wf)
        out = ttk.eikonal_iter(torch.as_tensor(arrays[0]).view(B, k, C),
                               *(torch.as_tensor(a) for a in arrays[1:]), _pack(*W), wf,
                               scale, 0.06)
        ref = _jax_ref_k8(kind, wf, arrays, W, scale, 0.06)
    _check(out, *ref, B=B, k=k)
