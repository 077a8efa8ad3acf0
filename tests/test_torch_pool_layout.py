"""The replay pool's row layout sized from ``nn_k`` and the offset width
``vec_dim`` (pin_slam_torch.slam.mapper), against the JAX package on the
CPU: the append-time kNN at k = 8 (which the JAX package's fixed k = 6 pool
cannot hold, ROADMAP C 2) laid into the port's rows, the k = 6 layout equal
to the JAX package's column for column at every offset width, and the
cached geometry's refresh with positional encoding.

Integers (neighbour ids, pool counters) exactly; IDW weights and (encoded)
offset vectors rtol 1e-5 / atol 1e-5 (the same float32 operations; an
encoder's sines of the same arguments).  After a deformation the two
packages' quaternion rotations round differently, which an encoder
amplifies by its largest angular frequency w: there atol is 1e-5 + 4e-7 w,
as in tests/test_torch_encodings.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.ops import encodings as tenc
from pin_slam_torch.slam import mapper as tm
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.ops.encodings import positional_encode
from pin_slam_tpu.slam import mapper as jm

torch.set_num_threads(1)
S_RAY, NEAR = 7, 4
ENCODINGS = {"none": dict(), "nerf4": dict(pos_encoding_band=4),
             "gauss16": dict(pos_encoding_band=16, use_gaussian_pe=True)}


def _setup(wf, k, enc):
    over = dict(weighted_first=wf, max_range=4.0, query_nn_k=k, **enc)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(800, 3)).astype(np.float32)
    travel = np.zeros((1 << 10,), np.float32)
    js = jn.map_insert(jn.init_map_state(jmc), jmc, jnp.asarray(pts), jnp.ones((800,), bool),
                       jnp.int32(0), jnp.asarray(travel), downsample_table_size=1 << 12)
    jlm = jn.build_local_map(js, jmc, jnp.zeros(3), jnp.int32(0), jnp.asarray(travel))
    ends = pts[rng.integers(0, 800, 60)]
    coords = (ends[:, None, :] + rng.normal(0, 0.25, (60, S_RAY, 3))).astype(np.float32)
    jt = jn.make_probe_template(jmc, jcfg.num_nei_cells, jcfg.search_alpha)
    tt = tn.make_probe_template(tmc, tcfg.num_nei_cells, tcfg.search_alpha)
    penc = ((lambda v: positional_encode(v, jcfg.pos_encoding_band,
                                         float(jcfg.pos_encoding_freq),
                                         float(jcfg.pos_encoding_base), jcfg.use_gaussian_pe))
            if jcfg.pos_encoding_band > 0 else None)
    return dict(jcfg=jcfg, tcfg=tcfg, jmc=jmc, tmc=tmc, js=js, jlm=jlm,
                tlm=tn.local_map_from_numpy(jlm), coords=coords.reshape(-1, 3), jt=jt, tt=tt,
                penc=penc, wf=wf)


def _append_knn(st):
    f = jax.jit(jm.append_knn, static_argnums=(1, 4),
                static_argnames=("near_count", "per_neighbor_vecs", "pos_encode"))
    jo = f(st["jlm"], st["jmc"], st["jt"], jnp.asarray(st["coords"]), S_RAY, near_count=NEAR,
           per_neighbor_vecs=not st["wf"], pos_encode=st["penc"])
    to = tm.append_knn(st["tlm"], st["tmc"], st["tt"], torch.as_tensor(st["coords"]), S_RAY,
                       near_count=NEAR, per_neighbor_vecs=not st["wf"],
                       pos_encode=st["tmc"].pos_encode)
    return jo, to


def _port_pool(st, to, valid):
    M = st["coords"].shape[0]
    mcfg = tm.MapperConfig.from_config(st["tcfg"])
    c = torch.as_tensor(st["coords"])
    pool = tm.pool_append(tm.init_pool(mcfg), mcfg, c, c - 1.0, torch.zeros(M), torch.ones(M),
                          torch.as_tensor(valid), 1, torch.zeros(M, dtype=torch.bool), to[0],
                          to[1], to[2], to[3])
    return mcfg, pool


@pytest.mark.parametrize("enc", list(ENCODINGS))
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_k8_rows_hold_the_jax_knn(wf, enc):
    """At k = 8 the rows hold JAX append_knn(k = 8)'s ids (exact), weights
    and vectors, in the valid samples' order."""
    st = _setup(wf, 8, ENCODINGS[enc])
    jo, to = _append_knn(st)
    assert np_(jo[0]).shape[1] == 8
    np.testing.assert_array_equal(np_(to[0]), np_(jo[0]))
    valid = np.random.default_rng(1).random(st["coords"].shape[0]) > 0.2
    mcfg, pool = _port_pool(st, to, valid)
    vd = st["tmc"].vec_dim
    assert mcfg.pool_dim == 9 + 16 + vd * (1 if wf else 9)
    rows = np_(pool.rows)[:int(pool.fill)]
    np.testing.assert_array_equal(rows[:, mcfg.p_knn], np_(jo[0])[valid].astype(np.float32))
    np.testing.assert_allclose(rows[:, mcfg.p_w], np_(jo[1])[valid], rtol=1e-5, atol=1e-5)
    p0 = mcfg.p_vec0
    np.testing.assert_allclose(rows[:, p0:p0 + vd], np_(jo[2])[valid], rtol=1e-5, atol=1e-5)
    if not wf:
        np.testing.assert_allclose(rows[:, p0 + vd:], np_(jo[3])[valid].reshape(-1, 8 * vd),
                                   rtol=1e-5, atol=1e-5)
    has = (rows[:, mcfg.p_knn] >= 0).any(1)
    assert has.mean() > 0.5
    np.testing.assert_allclose(rows[has][:, mcfg.p_w].sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("enc", list(ENCODINGS))
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_k6_layout_is_the_jax_layout(wf, enc):
    """At k = 6 the port's rows equal the JAX pool_append's column for column
    (ids exact), at every offset width."""
    st = _setup(wf, 6, ENCODINGS[enc])
    jo, to = _append_knn(st)
    M = st["coords"].shape[0]
    valid = np.random.default_rng(1).random(M) > 0.2
    mcfg, tp = _port_pool(st, to, valid)
    jmcfg = jm.MapperConfig.from_config(st["jcfg"])
    assert mcfg.pool_dim == jmcfg.pool_dim and mcfg.vec_dim == jmcfg.vec_dim
    assert (mcfg.p_knn, mcfg.p_w, mcfg.p_vec0) == (jm.P_KNN, jm.P_W, jm.P_VEC0)
    c = jnp.asarray(st["coords"])
    jp = jm.pool_append(jm.init_pool(jmcfg), jmcfg, c, c - 1.0, jnp.zeros(M), jnp.ones(M),
                        jnp.asarray(valid), jnp.int32(1), jnp.zeros(M, bool), None, None,
                        jo[0], jo[1], jo[2], knn_nbr_vec=None if wf else jo[3])
    for f in ("head", "fill", "new_count"):
        np.testing.assert_array_equal(np_(getattr(tp, f)), np_(getattr(jp, f)))
    jr, tr = np_(jp.rows), np_(tp.rows)
    np.testing.assert_array_equal(tr[:, :jm.P_W.start], jr[:, :jm.P_W.start])
    np.testing.assert_allclose(tr[:, jm.P_W.start:], jr[:, jm.P_W.start:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [6, 8])
@pytest.mark.parametrize("enc", ["nerf4", "gauss16"])
def test_refresh_cache_with_encoding_matches(k, enc):
    """pool_refresh_cache re-derives the weights and the encoded vectors
    after a deformation (moved points, rotated frames) as the JAX function
    does, keeping the neighbour ids; at k = 8 against the JAX package's
    idw_blend of the same neighbours (its refresh reads the k = 6 layout)."""
    st = _setup(False, k, ENCODINGS[enc])
    _, to = _append_knn(st)
    valid = np.ones(st["coords"].shape[0], bool)
    mcfg, tp = _port_pool(st, to, valid)
    rng = np.random.default_rng(2)
    attr = np_(st["js"].attr_rows).copy()
    n = int(st["js"].count)
    attr[:n, :3] += rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    q = np.concatenate([np.ones((n, 1)), rng.normal(0, 0.05, (n, 3))], 1)
    attr[:n, 3:7] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    before = np_(tp.rows).copy()
    tr = np_(tm.pool_refresh_cache(tp, torch.as_tensor(attr), st["tmc"],
                                   st["tmc"].pos_encode).rows)
    np.testing.assert_array_equal(tr[:, :mcfg.p_w.start], before[:, :mcfg.p_w.start])
    assert np.abs(tr[:, mcfg.p_w.start:] - before[:, mcfg.p_w.start:]).max() > 1e-4
    if k == 6:
        jpool = jm.init_pool(jm.MapperConfig.from_config(st["jcfg"]))._replace(
            rows=jnp.asarray(before), fill=jnp.int32(int(tp.fill)))
        jr = np_(jm.pool_refresh_cache(jpool, jnp.asarray(attr), st["jmc"], st["penc"]).rows)
    else:
        gidx = before[:, mcfg.p_knn].astype(np.int64)
        cap = st["jmc"].capacity
        nbr = attr[np.where(gidx >= 0, np.minimum(gidx, cap), cap)]
        coord = before[:, :3]
        d = nbr[..., :3] - coord[:, None, :]
        valid_k = (gidx >= 0) & ((d * d).sum(-1) <= st["jmc"].max_valid_dist2)
        w, vb, e = jax.jit(jm.idw_blend, static_argnames=("pos_encode", "return_per_neighbor"))(
            jnp.asarray(coord), jnp.asarray(nbr[..., :3]), jnp.asarray(valid_k),
            jnp.asarray(nbr[..., 3:7]), pos_encode=st["penc"], return_per_neighbor=True)
        jr = before.copy()
        jr[:, mcfg.p_w] = np_(w)
        jr[:, mcfg.p_vec0:] = np.concatenate([np_(vb), np_(e).reshape(len(jr), -1)], 1)
    tmc = st["tmc"]
    w_max = (2 * np.pi * np.abs(tenc._gaussian_B(3, 16, tmc.pos_encoding_freq, 42)).sum(0).max()
             if tmc.use_gaussian_pe else np.pi * tmc.pos_encoding_freq / 2)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-5 + 4e-7 * w_max)
