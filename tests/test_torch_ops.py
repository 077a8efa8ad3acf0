"""pin_slam_torch ops against the JAX package on the CPU: spatial hash and
voxel keep masks (exact), transforms / small matrices / losses / sampler /
decoder (float tolerances stated per case)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import both, decoder_pair, np_

from pin_slam_torch.models import decoder as tdec
from pin_slam_torch.ops import hash3d as th, losses as tl, sampler as ts
from pin_slam_torch.ops import smallmat as tsm, transforms as ttf, voxel as tv
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.ops import hash3d as jh, losses as jl, sampler as js
from pin_slam_tpu.ops import smallmat as jsm, transforms as jtf, voxel as jv

torch.set_num_threads(1)


def _rot(rng):
    w = rng.normal(size=3) * 0.7
    return np.asarray(jtf.so3_expmap(jnp.asarray(w, jnp.float32)))


def case_hash(rng):
    grid = rng.integers(-5000, 5000, size=(4000, 3)).astype(np.int32)
    grid[:10] = [[-1, -1, -1], [0, 0, 0], [2 ** 31 - 1, -2 ** 31, 7]] + [[3, -4, 5]] * 7
    for size in (1 << 20, 1000003, 37):
        jg, tg = both(grid)
        np.testing.assert_array_equal(np_(th.spatial_hash(tg, size)),
                                      np_(jh.spatial_hash(jg, size)))
    # the JAX package runs these jitted (division by a constant becomes a
    # multiply by its reciprocal there); points on voxel boundaries included
    pts = rng.uniform(-30, 30, size=(2000, 3)).astype(np.float32)
    pts[:200] = np.round(pts[:200] / 0.4) * 0.4
    jp, tp = both(pts)
    np.testing.assert_array_equal(np_(th.grid_coords(tp, 0.4)),
                                  np_(jax.jit(jh.grid_coords, static_argnums=1)(jp, 0.4)))


def case_voxel(rng):
    # clusters of near-duplicate points (ties in the packed score) + padding
    base = rng.uniform(-5, 5, size=(300, 3)).astype(np.float32)
    base[:60] = np.round(base[:60] / 0.3) * 0.3
    pts = np.concatenate([base, base[:100], base[:50] + 1e-4,
                          rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)])
    valid = rng.random(pts.shape[0]) > 0.1
    jp, tp = both(pts)
    jvld, tvld = both(valid)
    for vs, table in ((0.5, 1 << 16), (0.3, 1 << 12), (2.0, 97)):
        np.testing.assert_array_equal(
            np_(tv.voxel_down_sample_mask(tp, tvld, vs, table)),
            np_(jax.jit(jv.voxel_down_sample_mask, static_argnums=(2, 3))(
                jp, jvld, vs, table)))
    arr, vld = tv.pad_to(pts[:7], 10)
    arr_j, vld_j = jv.pad_to(pts[:7], 10)
    np.testing.assert_array_equal(arr, arr_j)
    np.testing.assert_array_equal(vld, vld_j)


def case_transforms(rng):
    # float32 elementwise geometry: agreement to a few ulps of O(1) values
    tol = dict(rtol=1e-5, atol=2e-6)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-8
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    for tf, jf, x in ((ttf.so3_expmap, jtf.so3_expmap, w), (ttf.se3_expmap, jtf.se3_expmap, xi)):
        jx, tx = both(x)
        np.testing.assert_allclose(np_(tf(tx)), np_(jf(jx)), **tol)
    Rs = np.stack([_rot(rng) for _ in range(32)]).astype(np.float32)
    jR, tR = both(Rs)
    np.testing.assert_allclose(np_(ttf.rotmat_to_quat(tR)), np_(jtf.rotmat_to_quat(jR)), **tol)
    np.testing.assert_allclose(np_(ttf.so3_logmap(tR)), np_(jtf.so3_logmap(jR)),
                               rtol=1e-4, atol=2e-5)   # arccos near 0 amplifies ulps
    Ts = np.asarray(jtf.se3_expmap(jnp.asarray(xi[:32] * 0.5)))
    jT, tT = both(Ts)
    np.testing.assert_allclose(np_(ttf.se3_logmap(tT)), np_(jtf.se3_logmap(jT)),
                               rtol=1e-4, atol=2e-5)   # built on so3_logmap: same reason
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jq, tq = both(q)
    np.testing.assert_allclose(np_(ttf.quat_to_rotmat(tq)), np_(jtf.quat_to_rotmat(jq)), **tol)
    np.testing.assert_allclose(np_(ttf.quat_multiply(tq, tq.flip(0))),
                               np_(jtf.quat_multiply(jq, jq[::-1])), **tol)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    jpp, tpp = both(p)
    np.testing.assert_allclose(np_(ttf.apply_quaternion_rotation(tq, tpp)),
                               np_(jtf.apply_quaternion_rotation(jq, jpp)), **tol)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = _rot(rng), rng.normal(size=3)
    np.testing.assert_allclose(ttf.np_se3_inverse(T), jtf.np_se3_inverse(T), atol=1e-12)


def case_smallmat(rng):
    # unrolled 6x6 Cholesky in the same operation order: float32 agreement
    # to ~1e-5 relative on a well-conditioned SPD system
    for _ in range(5):
        A = rng.normal(size=(6, 6)).astype(np.float32)
        A = A @ A.T + 6 * np.eye(6, dtype=np.float32)
        b = rng.normal(size=6).astype(np.float32)
        jA, tA = both(A)
        jb, tb = both(b)
        np.testing.assert_allclose(np_(tsm.cholesky_solve6(tA, tb)),
                                   np_(jsm.cholesky_solve6(jA, jb)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np_(tsm.cholesky_inverse6(tA)),
                                   np_(jsm.cholesky_inverse6(jA)), rtol=1e-5, atol=1e-6)
        S = A[:3, :3]
        jS, tS = both(S)
        np.testing.assert_allclose(float(tsm.sym_eigvals_min3(tS)),
                                   float(jsm.sym_eigvals_min3(jS)), rtol=1e-5)
    D = np.diag([3.0, 1.0, 2.0]).astype(np.float32)    # degenerate branch
    assert float(tsm.sym_eigvals_min3(torch.as_tensor(D))) == 1.0


def case_losses(rng):
    pred = rng.normal(size=256).astype(np.float32) * 0.3
    label = rng.normal(size=256).astype(np.float32) * 0.3
    wt = rng.random(256).astype(np.float32)
    valid = rng.random(256) > 0.2
    g = rng.normal(size=(256, 3)).astype(np.float32)
    g[:5] = 0.0
    jpr, tpr = both(pred)
    jl_, tl_ = both(label)
    jw, tw = both(wt)
    jv_, tv_ = both(valid)
    jg, tg = both(g)
    np.testing.assert_allclose(float(tl.sdf_bce_loss(tpr, tl_, 0.1, tw, True, tv_)),
                               float(jl.sdf_bce_loss(jpr, jl_, 0.1, jw, True, jv_)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.eikonal_loss(tg, tv_)),
                               float(jl.eikonal_loss(jg, jv_)), rtol=1e-6)


def case_sampler(rng):
    # the JAX package's own threefry draws are handed to the port
    sc_j = js.SamplerConfig(surface_sample_n=4, free_front_n=2, free_behind_n=1,
                            behind_dropoff_on=True)
    sc_t = ts.SamplerConfig(**sc_j.__dict__)
    n = 300
    pts = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    pts[0] = 0.0
    valid = rng.random(n) > 0.1
    key = jax.random.PRNGKey(5)
    k_surf, k_front, k_behind = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(d)) for d in (
        jax.random.normal(k_surf, (n, sc_j.surface_sample_n)),
        jax.random.uniform(k_front, (n, sc_j.free_front_n)),
        jax.random.uniform(k_behind, (n, sc_j.free_behind_n))))
    jb = js.sample_rays(key, sc_j, jnp.asarray(pts), jnp.asarray(valid))
    tb = ts.sample_rays(sc_t, torch.as_tensor(pts), torch.as_tensor(valid), draws)
    np.testing.assert_array_equal(np_(tb.valid), np_(jb.valid))
    for a, b in ((tb.coord, jb.coord), (tb.sdf_label, jb.sdf_label), (tb.weight, jb.weight)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-5)


def case_decoder(rng):
    # same weights (params_from_jax): decoded values agree to float32 matmul
    # rounding (different BLAS summation order)
    p, dec = decoder_pair(3, 11, 64)
    x = rng.normal(size=(128, 6, 11)).astype(np.float32)
    w = rng.random((128, 6)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    jx, tx = both(x)
    jw, tw = both(w)
    np.testing.assert_allclose(np_(dec.sdf(tx, 0.055)), np_(jdec.sdf(p, jx, 0.055)),
                               rtol=1e-5, atol=1e-6)
    for wf in (True, False):
        xin_t, xin_j = (tx[:, 0], jx[:, 0]) if wf else (tx, jx)
        got = dec.blended_sdf(xin_t, tw, wf, 0.055)
        ref = jdec.blended_sdf(p, xin_j, jw, wf, 0.055)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-6)
    state = tdec.params_from_jax(jax.tree.map(np.asarray, p))
    assert state["hidden.0.weight"].shape == (64, 11)
    np.testing.assert_array_equal(state["hidden.0.weight"].numpy(), np.asarray(p.hidden[0][0]).T)
    vec = dec.pack()
    dec2 = tdec.Decoder(11, 64, 1, 1)
    dec2.load_packed(vec)
    np.testing.assert_array_equal(dec2.pack().numpy(), vec.numpy())


CASES = {"hash": case_hash, "voxel": case_voxel, "transforms": case_transforms,
         "smallmat": case_smallmat, "losses": case_losses, "sampler": case_sampler,
         "decoder": case_decoder}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_match_jax(name):
    CASES[name](np.random.default_rng(11))
