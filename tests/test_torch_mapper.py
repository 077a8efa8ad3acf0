"""The port's mapper against the JAX package's on the CPU: the append-time
kNN (with the voxel-dedup group probe and the brick template), the pool
append / filter layout, and mapping_loop_cached for 3 iterations against the
JAX kernel path (Pallas in interpret mode), in both interpolation modes.

Integers (neighbour ids, drop flags, pool counters and index lists) must
match exactly.  Float tolerances: IDW weights / blended vectors rtol 1e-5;
features, decoder and certainty after 3 Adam steps atol 1e-4 (Adam with
eps 1e-15 turns rounding-level gradient differences into step-size ones)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import decoder_pair, np_, pack_jax_decoder, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.slam import mapper as tm
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.slam import mapper as jm

torch.set_num_threads(1)
S_RAY, NEAR = 7, 4


@pytest.fixture(scope="module", params=[True, False], ids=["wf", "per_neighbor"])
def setup(request):
    wf = request.param
    over = dict(bs=256, bs_new_sample=32, iters=3, weighted_first=wf, max_range=4.0)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(800, 3)).astype(np.float32)
    travel = np.zeros((1 << 10,), np.float32)
    js = jn.map_insert(jn.init_map_state(jmc), jmc, jnp.asarray(pts), jnp.ones((800,), bool),
                       jnp.int32(0), jnp.asarray(travel), downsample_table_size=1 << 12)
    jlm = jn.build_local_map(js, jmc, jnp.zeros(3), jnp.int32(0), jnp.asarray(travel))
    tlm = tn.local_map_from_numpy(jlm)
    n_rays = 60
    ends = pts[rng.integers(0, 800, n_rays)]
    coords = (ends[:, None, :] + rng.normal(0, 0.25, (n_rays, S_RAY, 3))).astype(np.float32)
    coords[:10, NEAR:] = ends[:10, None, :] + 0.01      # shared far voxels -> dedup groups
    coords = coords.reshape(-1, 3)
    tmpl_j = jn.make_probe_template(jmc, jcfg.num_nei_cells, jcfg.search_alpha)
    tmpl_t = tn.make_probe_template(tmc, tcfg.num_nei_cells, tcfg.search_alpha)
    return dict(wf=wf, jmc=jmc, tmc=tmc, jmcfg=jmcfg, tmcfg=tmcfg, jlm=jlm, tlm=tlm,
                coords=coords, tmpl_j=tmpl_j, tmpl_t=tmpl_t, rng=rng)


def _append(st, far_budget):
    wf = st["wf"]
    f = jax.jit(jm.append_knn, static_argnums=(1, 4),
                static_argnames=("near_count", "per_neighbor_vecs", "dedup_far_budget",
                                 "return_dropped"))
    jo = f(st["jlm"], st["jmc"], st["tmpl_j"], jnp.asarray(st["coords"]), S_RAY,
           near_count=NEAR, per_neighbor_vecs=not wf, dedup_far_budget=far_budget,
           return_dropped=True)
    to = tm.append_knn(st["tlm"], st["tmc"], st["tmpl_t"], torch.as_tensor(st["coords"]), S_RAY,
                       near_count=NEAR, per_neighbor_vecs=not wf, dedup_far_budget=far_budget)
    return jo, to


# (far dedup budget, whether items over it are dropped); the port has no
# endpoint dedup (``probe_dedup_near_budget`` > 0 raises), so it stays 0
@pytest.mark.parametrize("budgets", [(0, False), (40, True), (10, True)])
def test_append_knn_matches(setup, budgets):
    jo, to = _append(setup, budgets[0])
    np.testing.assert_array_equal(np_(to[0]), np_(jo[0]))                 # gidx
    np.testing.assert_array_equal(np_(to[-1]), np_(jo[-1]))               # dropped
    np.testing.assert_allclose(np_(to[1]), np_(jo[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(to[2]), np_(jo[2]), rtol=1e-5, atol=1e-6)
    if not setup["wf"]:
        np.testing.assert_allclose(np_(to[3]), np_(jo[3]), rtol=1e-5, atol=1e-6)
    assert (np_(jo[0]) >= 0).any()
    assert np_(jo[-1]).any() == budgets[1]


def _pools(st):
    """One frame appended to both pools from the same kNN cache."""
    jo, to = _append(st, 200)
    rng = np.random.default_rng(1)
    M = st["coords"].shape[0]
    label = rng.normal(0, 0.2, M).astype(np.float32)
    weight = np.where(rng.random(M) > 0.5, 1.0, -1.0).astype(np.float32)
    valid = (rng.random(M) > 0.15) & ~np_(jo[-1])
    new_mask = rng.random(M) > 0.6
    jp = jm.pool_append(jm.init_pool(st["jmcfg"]), st["jmcfg"], jnp.asarray(st["coords"]),
                        jnp.asarray(st["coords"]) - 1.0, jnp.asarray(label),
                        jnp.asarray(weight), jnp.asarray(valid), jnp.int32(1),
                        jnp.asarray(new_mask), None, None, jo[0], jo[1], jo[2],
                        knn_nbr_vec=None if st["wf"] else jo[3])
    tp = tm.pool_append(tm.init_pool(st["tmcfg"]), st["tmcfg"], torch.as_tensor(st["coords"]),
                        torch.as_tensor(st["coords"]) - 1.0, torch.as_tensor(label),
                        torch.as_tensor(weight), torch.as_tensor(valid), 1,
                        torch.as_tensor(new_mask), to[0], to[1], to[2], to[3])
    return jp, tp


def test_pool_append_and_filter_match(setup):
    jp, tp = _pools(setup)
    for f in ("head", "fill", "new_count", "new_idx"):
        np.testing.assert_array_equal(np_(getattr(tp, f)), np_(getattr(jp, f)), err_msg=f)
    jr, tr = np_(jp.rows), np_(tp.rows)
    np.testing.assert_array_equal(tr[:, :15], jr[:, :15])            # coords..knn ids
    np.testing.assert_allclose(tr[:, 15:], jr[:, 15:], rtol=1e-5, atol=1e-6)
    origin = np.asarray([1.0, 0.5, 0.0], np.float32)
    mc = dataclasses.replace(setup["jmcfg"], window_radius=2.5)
    tmc = dataclasses.replace(setup["tmcfg"], window_radius=2.5)
    jf = jm.pool_filter(jp, mc, jnp.asarray(origin))
    tf = tm.pool_filter(tp, tmc, torch.as_tensor(origin))
    assert 0 < int(tf.fill) == int(jf.fill) < int(jp.fill)
    for f in ("head", "new_count"):
        np.testing.assert_array_equal(np_(getattr(tf, f)), np_(getattr(jf, f)))
    np.testing.assert_array_equal(np_(tf.rows)[:, :15], np_(jf.rows)[:, :15])


def test_mapping_loop_cached_matches_kernel_path(setup):
    jp, _ = _pools(setup)
    st = setup
    jmc, jmcfg, tmcfg = st["jmc"], st["jmcfg"], st["tmcfg"]
    L, F = jmc.local_capacity, jmc.feature_dim
    rng = np.random.default_rng(2)
    feats = np.concatenate([0.01 * rng.standard_normal((L + 1, F)), np.zeros((L + 1, 1))],
                           1).astype(np.float32)
    geo, _ = decoder_pair(1, F + 3, 64)
    params = jm.TrainableParams(features=jnp.asarray(feats), color_features=None, geo=geo,
                                sem=None, color=None)
    key = jax.random.PRNGKey(0)
    lm_j, p_j, _, hist_j = jm.mapping_loop_cached(
        st["jlm"], jmc, params, jm.init_opt_state(jmcfg, params), jp, jmcfg, key,
        jnp.float32(1.0), jnp.ones((), bool), num_iters=3, use_kernel=True)
    idx = jm._sample_batch_indices(key, jp, jmcfg, jnp.ones((), bool), 3)
    tpool = tm.pool_from_numpy(jp)
    f0, g0 = torch.as_tensor(feats), pack_jax_decoder(geo)
    lm_t, f_t, g_t, _, hist_t = tm.mapping_loop_cached(
        st["tlm"], st["tmc"], f0, g0, tm.init_opt_state(f0, g0), tpool, tmcfg,
        torch.as_tensor(np.array(idx), dtype=torch.int64), 1.0)
    np.testing.assert_allclose(np_(hist_t), np_(hist_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np_(f_t), np_(p_j.features), atol=1e-4)
    np.testing.assert_allclose(np_(g_t).astype(np.float64), np_(pack_jax_decoder(p_j.geo)),
                               atol=1e-4)
    np.testing.assert_allclose(np_(lm_t.attr_rows)[:, 7], np_(lm_j.attr_rows)[:, 7],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(lm_t.attr_rows)[:, 9], np_(lm_j.attr_rows)[:, 9])
    assert np.abs(np_(f_t) - feats).max() > 1e-3                      # it trained
