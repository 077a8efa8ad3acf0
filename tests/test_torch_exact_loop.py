"""The port's exact-kNN training loop (``mapper.mapping_loop``, run under
PIN_SLAM_EXACT_KNN=1) against the JAX package's ``mapping_loop`` from the
same state and batches, the uncached closed-form SDF gradient
(``tracker_grad.sdf_value_and_grad``), and the tracker with positional
encoding, on the CPU.

The loop: its fast branch (weighted_first), the general branch per
neighbour, with feature layer-norm, with the semantic head, with the colour
head, with NeRF encoding and at k = 8, each 3 iterations.  Features,
decoders and the loss history within 1e-4 (the tolerance of
test_torch_semantic.py::test_autograd_loop_matches: Adam with eps 1e-15
turns rounding-level gradient differences into step-size ones), certainty
allclose (rtol / atol 1e-4), update stamps exact.  The features start
random (0.01 N(0, 1)): the JAX layer-norm's gradient is NaN on a row of
equal values (ROADMAP C 16)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import decoder as tdec
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.slam import mapper as tm
from pin_slam_torch.slam import tracker_grad as ttg
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.slam import mapper as jm
from pin_slam_tpu.slam import tracker_grad as jtg

torch.set_num_threads(1)
ITERS = 3
SIZES = dict(bs=256, bs_new_sample=32, iters=ITERS, max_range=4.0, gradient_decimation=8)


@pytest.fixture(scope="module")
def scene():
    jcfg = small_config(JConfig, **SIZES)
    jmc = jn.MapConfig.from_config(jcfg)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(800, 3)).astype(np.float32)
    travel = np.zeros((1 << 10,), np.float32)
    js = jn.map_insert(jn.init_map_state(jmc), jmc, jnp.asarray(pts), jnp.ones((800,), bool),
                       jnp.int32(0), jnp.asarray(travel), downsample_table_size=1 << 12)
    jlm = jn.build_local_map(js, jmc, jnp.zeros(3), jnp.int32(0), jnp.asarray(travel))
    L, F = jmc.local_capacity, jmc.feature_dim
    attr = np.array(jlm.attr_rows)
    q = rng.normal(size=(L + 1, 4)).astype(np.float32) * 0.1
    q[:, 0] = 1.0
    attr[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)      # a deformed map
    jlm = jlm._replace(attr_rows=jnp.asarray(attr))
    M = 1200
    coords = (pts[rng.integers(0, 800, M)] + rng.normal(0, 0.2, (M, 3))).astype(np.float32)
    samples = dict(coords=coords, label=rng.normal(0, 0.2, M).astype(np.float32),
                   weight=np.where(rng.random(M) > 0.3, 1.0, -1.0).astype(np.float32),
                   ts=rng.integers(0, 4, M), sem=rng.integers(0, 20, M).astype(np.int32),
                   color=rng.random((M, 3)).astype(np.float32))
    feats = (0.01 * rng.standard_normal((L + 1, F))).astype(np.float32)
    cfeats = (0.01 * rng.standard_normal((L + 1, F))).astype(np.float32)
    return dict(jcfg=jcfg, jmc=jmc, jlm=jlm, samples=samples, feats=feats, cfeats=cfeats)


def _pool(jmcfg, smp):
    """The samples, appended frame by frame (their frame ids), with their
    classes and colours; the exact loop reads no cached kNN."""
    pool = jm.init_pool(jmcfg)
    for f in range(4):
        sel = smp["ts"] == f
        n = int(sel.sum())
        pool = jm.pool_append(pool, jmcfg, jnp.asarray(smp["coords"][sel]),
                              jnp.asarray(smp["coords"][sel]), jnp.asarray(smp["label"][sel]),
                              jnp.asarray(smp["weight"][sel]), jnp.ones((n,), bool),
                              jnp.int32(f), jnp.asarray(np.arange(n) % 3 == 0),
                              sem_label=(jnp.asarray(smp["sem"][sel]) if jmcfg.semantic_on
                                         else None),
                              color_label=(jnp.asarray(smp["color"][sel]) if jmcfg.color_on
                                           else None))
    return pool


CASES = {
    "fast": dict(weighted_first=True),
    "general_per_neighbor": dict(weighted_first=False),
    "general_layer_norm": dict(weighted_first=True, layer_norm_on=True),
    "semantic": dict(weighted_first=False, semantic_on=True),
    "colour": dict(weighted_first=True, color_on=True),
    "nerf_per_neighbor": dict(weighted_first=False, pos_encoding_band=2),
    "k8": dict(weighted_first=False, query_nn_k=8, layer_norm_on=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mapping_loop_matches(scene, case):
    over = CASES[case]
    jcfg, tcfg = small_config(JConfig, **SIZES, **over), small_config(TConfig, **SIZES, **over)
    jmc = jn.MapConfig.from_config(jcfg)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    tmc = tn.MapConfig.from_config(tcfg)
    assert (jmc.weighted_first, jmc.layer_norm_on, jmc.nn_k) == (
        tmc.weighted_first, tmc.layer_norm_on, tmc.nn_k)
    jlm = scene["jlm"]
    L, F = jmc.local_capacity, jmc.feature_dim
    vd = tmc.vec_dim
    key = jax.random.PRNGKey(3)
    geo = jdec.init_decoder(jax.random.PRNGKey(1), F + vd, 64, 1, 1)
    sem = (jdec.init_decoder(jax.random.PRNGKey(2), F + vd, 64, 1, 20)
           if over.get("semantic_on") else None)
    col = jdec.init_decoder(jax.random.PRNGKey(4), F + vd, 64, 1, 3) if over.get("color_on") \
        else None
    jlm_c = jlm._replace(color_features=jnp.asarray(scene["cfeats"])) if col else jlm
    params = jm.TrainableParams(features=jnp.asarray(scene["feats"]),
                                color_features=jnp.asarray(scene["cfeats"]) if col else None,
                                geo=geo, sem=sem, color=col)
    pool = _pool(jmcfg, scene["samples"])
    offs = jnp.asarray(jn.neighbor_offsets(jcfg.num_nei_cells, jcfg.search_alpha))
    lm_j, p_j, _, hist_j = jm.mapping_loop(jlm_c, jmc, params, jm.init_opt_state(jmcfg, params),
                                           pool, jmcfg, offs, key, jnp.float32(1.0),
                                           jnp.ones((), bool), jnp.asarray(True), ITERS)
    idx = jm._sample_batch_indices(key, pool, jmcfg, jnp.ones((), bool), ITERS)

    tlm = tn.local_map_from_numpy(jlm_c)
    heads = tm.init_heads(tdec.decoder_from_jax(geo),
                          tdec.decoder_from_jax(sem) if sem is not None else None)
    color = (tm.init_color_state(torch.as_tensor(scene["cfeats"]), tdec.decoder_from_jax(col))
             if col is not None else None)
    f0 = torch.as_tensor(scene["feats"])
    lm_t, f_t, h_t, _, hist_t = tm.mapping_loop(
        tlm, tmc, f0, heads, tm.init_opt_state(f0, heads), tm.pool_from_numpy(pool), tmcfg,
        torch.as_tensor(np.asarray(offs)), torch.as_tensor(np.array(idx), dtype=torch.int64),
        1.0, after_pgo=True, color=color)

    np.testing.assert_allclose(np_(hist_t), np_(hist_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np_(f_t), np_(p_j.features), atol=1e-4)
    trained = [(h_t.geo_params, p_j.geo)]
    if sem is not None:
        trained.append((h_t.sem_params, p_j.sem))
    if col is not None:
        trained.append((color.params, p_j.color))
        np.testing.assert_allclose(np_(color.features), np_(p_j.color_features), atol=1e-4)
    for leaves, jp in trained:
        ref = tdec.decoder_from_jax(jp)
        for a, b in zip(leaves, ref.parameters()):
            np.testing.assert_allclose(np_(a), np_(b), atol=1e-4)
    np.testing.assert_allclose(np_(lm_t.attr_rows)[:, tn.C_CERT],
                               np_(lm_j.attr_rows)[:, tn.C_CERT], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np_(lm_t.attr_rows)[:, tn.C_TSU],
                                  np_(lm_j.attr_rows)[:, tn.C_TSU])
    assert np.abs(np_(f_t) - scene["feats"]).max() > 1e-3                 # it trained
    assert np.abs(np_(lm_t.attr_rows)[:, tn.C_CERT] - np_(jlm.attr_rows)[:, tn.C_CERT]).max() > 0


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
@pytest.mark.parametrize("after_pgo", [False, True], ids=["", "after_pgo"])
def test_sdf_value_and_grad_matches(scene, wf, after_pgo):
    """The uncached closed form: a fresh kNN, then the analytic core."""
    jmc = dataclasses.replace(scene["jmc"], weighted_first=wf)
    tmc = tn.MapConfig(**{f.name: getattr(jmc, f.name) for f in dataclasses.fields(tn.MapConfig)})
    F = jmc.feature_dim
    geo = jdec.init_decoder(jax.random.PRNGKey(5), F + 3, 64, 1, 1)
    jlm = scene["jlm"]._replace(geo_features=jnp.asarray(scene["feats"] * 30.0))
    tlm = tn.local_map_from_numpy(jlm)
    pts = scene["samples"]["coords"][:400]
    offs = jn.neighbor_offsets(scene["jcfg"].num_nei_cells, scene["jcfg"].search_alpha)
    jr = jax.jit(jtg.sdf_value_and_grad, static_argnums=(1, 3))(
        jlm, jmc, geo, 0.3, jnp.asarray(offs), jnp.asarray(pts), after_pgo)
    tr = ttg.sdf_value_and_grad(tlm, tmc, tdec.decoder_from_jax(geo), 0.3,
                                torch.as_tensor(offs), torch.as_tensor(pts), after_pgo)
    np.testing.assert_array_equal(np_(tr[2]), np_(jr[2]))                 # nn_count
    for a, b in ((tr[0], jr[0]), (tr[1], jr[1]), (tr[3], jr[3])):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-5)
    assert (np_(tr[2]) >= 2).mean() > 0.5                           # queries with neighbours
    with pytest.raises(ValueError, match="autograd"):
        ttg.sdf_value_and_grad(tlm, dataclasses.replace(tmc, pos_encoding_band=2),
                               tdec.decoder_from_jax(geo), 0.3, torch.as_tensor(offs),
                               torch.as_tensor(pts))
