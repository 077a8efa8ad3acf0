"""The colour head in the port's autograd training loop against the JAX
package's autodiff loop on the CPU: ``mapping_loop_autograd`` with a colour
state beside the semantic head, and beside a two-layer SDF decoder (the
configurations the training kernels do not cover), in both interpolation
modes, one call (T = 3) from the same state and batch indices against JAX
``mapping_loop_cached(use_kernel=False)``.

The JAX package takes one Adam step over its whole tree with the colour
decoder's gradient scaled by ``decoder_lr_scale``; the port takes the
colour leaves' own Adam step with the same scale and step count.  Adam
works element by element, so the two must agree.  Tolerances, as
tests/test_torch_semantic.py states them for the loop: the loss history
rtol 1e-4; every trained leaf (features, each decoder leaf, colour
features, each colour-decoder leaf) within 1e-4 of its largest magnitude;
the certainty column within 1e-5 of its largest; the update stamps exact."""

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
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.slam import mapper as jm

torch.set_num_threads(1)
BASE = dict(color_map_on=True, color_on=True, color_channel=3, map_capacity=1 << 14,
            local_map_capacity=1 << 12, buffer_size=1 << 18, downsample_hash_size=1 << 16,
            max_range=8.0)


def _cfgs(**over):
    base = {**BASE, **over}
    return small_config(JConfig, **base), small_config(TConfig, **base)


def _pair(seed, in_dim, H, level, out, bias=True, scale_out=1.0):
    p = jdec.init_decoder(jax.random.PRNGKey(seed), in_dim, H, level, out, bias)
    if scale_out != 1.0:
        W, b = p.out
        p = p._replace(out=(W * scale_out, b))
    return p, tdec.decoder_from_jax(p)


def _layers(p):
    return [x for pair in list(p.hidden) + [p.out] for x in pair if x is not None]


@pytest.fixture(scope="module")
def maps():
    """Both packages' maps after two inserts, and their local maps."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = _cfgs()
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    travel = np.zeros((64,), np.float32)
    travel[1] = 3.0
    a = rng.uniform(-5, 5, size=(2500, 3)).astype(np.float32)
    b = np.concatenate([a[:600] + rng.normal(0, 0.05, (600, 3)).astype(np.float32),
                        rng.uniform(-8, 3, size=(900, 3)).astype(np.float32)])
    js, ts_ = jn.init_map_state(jmc), tn.init_map_state(tmc)
    for fid, pts in ((0, a), (1, b)):
        valid = rng.random(pts.shape[0]) > 0.05
        js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.asarray(valid), jnp.int32(fid),
                           jnp.asarray(travel), downsample_table_size=jcfg.downsample_hash_size,
                           insert_bucket=1024)
        ts_ = tn.map_insert(ts_, tmc, torch.as_tensor(pts), torch.as_tensor(valid), fid,
                            torch.as_tensor(travel),
                            downsample_table_size=tcfg.downsample_hash_size, insert_bucket=1024)
    origin = np.asarray([0.5, -0.25, 0.0], np.float32)
    jlm = jn.build_local_map(js, jmc, jnp.asarray(origin), jnp.int32(1), jnp.asarray(travel))
    tlm = tn.build_local_map(ts_, tmc, torch.as_tensor(origin), 1, torch.as_tensor(travel))
    return dict(jmc=jmc, tmc=tmc, jlm=jlm, tlm=tlm)


@pytest.mark.parametrize("head", ["semantic", "deep_sdf"])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_autograd_loop_with_colour_matches(maps, wf, head):
    sem_on, level = head == "semantic", 2 if head == "deep_sdf" else 1
    jcfg, tcfg = _cfgs(bs=256, bs_new_sample=32, iters=3, weighted_first=wf,
                       pool_capacity=1 << 12, semantic_on=sem_on, geo_mlp_level=level)
    jmc = dataclasses.replace(maps["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(maps["tmc"], weighted_first=wf)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    assert not tm.kernel_path_supported(tmcfg, tcfg) and tmcfg.color_on
    jlm, tlm = maps["jlm"], maps["tlm"]
    rng = np.random.default_rng(16)
    pos = np_(tlm.positions)[: int(tlm.count)]
    S, near, n_rays = 7, 4, 120
    ends = pos[rng.integers(0, pos.shape[0], n_rays)]
    coords = (ends[:, None, :] + rng.normal(0, 0.08, (n_rays, S, 3))).astype(np.float32)
    coords[:, 0] = ends
    coords = coords.reshape(-1, 3)
    tmpl = jn.make_probe_template(jmc, jcfg.num_nei_cells, jcfg.search_alpha)
    f = jax.jit(jm.append_knn, static_argnums=(1, 4),
                static_argnames=("near_count", "per_neighbor_vecs", "return_dropped"))
    gidx, w, vec, *rest = f(jlm, jmc, tmpl, jnp.asarray(coords), S, near_count=near,
                            per_neighbor_vecs=not wf, return_dropped=True)
    M = coords.shape[0]
    label = np.where(np.arange(M) % S == 0, 0.0, rng.normal(0, 0.1, M)).astype(np.float32)
    weight = rng.uniform(0.5, 1.4, M).astype(np.float32)
    sem = np.where(np.arange(M) % S < near, rng.integers(0, 20, M), 0).astype(np.int32)
    col = rng.random((M, 3)).astype(np.float32)
    jp = jm.pool_append(jm.init_pool(jmcfg, color_channel=3), jmcfg, jnp.asarray(coords),
                        jnp.asarray(coords), jnp.asarray(label), jnp.asarray(weight),
                        jnp.ones((M,), bool), jnp.int32(1), jnp.asarray(rng.random(M) > 0.5),
                        jnp.asarray(sem) if sem_on else None, jnp.asarray(col), gidx, w, vec,
                        knn_nbr_vec=None if wf else rest[0])
    L, F = tmc.local_capacity, tmc.feature_dim
    feats = np.concatenate([0.05 * rng.standard_normal((L + 1, F)), np.zeros((L + 1, 1))],
                           1).astype(np.float32)
    cf = rng.normal(size=(L + 1, F)).astype(np.float32)
    cf[L] = 0.0
    jgeo, tgeo = _pair(18, F + 3, 64, level, 1)
    jsem, tsem = _pair(19, F + 3, 64, 1, 20) if sem_on else (None, None)
    jcol, tcol = _pair(21, F + 3, 64, 1, 3, scale_out=4.0)   # part of the colours clip

    params = jm.TrainableParams(features=jnp.asarray(feats), color_features=jnp.asarray(cf),
                                geo=jgeo, sem=jsem, color=jcol)
    key = jax.random.PRNGKey(20)
    lm_j, p_j, _, hist_j = jm.mapping_loop_cached(
        jlm, jmc, params, jm.init_opt_state(jmcfg, params), jp, jmcfg, key, jnp.float32(0.7),
        jnp.ones((), bool), num_iters=3, use_kernel=False)
    idx = torch.as_tensor(np.array(jm._sample_batch_indices(key, jp, jmcfg, jnp.ones((), bool),
                                                            3)), dtype=torch.int64)
    f0 = torch.as_tensor(feats)
    heads = tm.init_heads(tgeo, tsem)
    color = tm.init_color_state(torch.as_tensor(cf), tcol)
    lm_t, f_t, heads, _, hist_t = tm.mapping_loop_autograd(
        tlm, tmc, f0, heads, tm.init_opt_state(f0, heads), tm.pool_from_numpy(jp), tmcfg, idx,
        0.7, color=color)
    np.testing.assert_allclose(np_(hist_t), np_(hist_j), rtol=1e-4)
    heads.load_into(tgeo, tsem)
    color.load_into(tcol)
    pairs = [(np_(f_t), np_(p_j.features)), (np_(color.features), np_(p_j.color_features))]
    for tdec_, jp_ in ((tgeo, p_j.geo), (tsem, p_j.sem), (tcol, p_j.color)):
        if tdec_ is not None:
            tl = [x for pair in tdec_.layers() for x in pair if x is not None]
            pairs += list(zip([np_(x) for x in tl], [np_(x) for x in _layers(jp_)]))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), err_msg=f"leaf {i}")
    cert_t, cert_j = np_(lm_t.attr_rows)[:, 7], np_(lm_j.attr_rows)[:, 7]
    np.testing.assert_allclose(cert_t, cert_j, atol=1e-5 * np.abs(cert_j).max())
    np.testing.assert_array_equal(np_(lm_t.attr_rows)[:, 9], np_(lm_j.attr_rows)[:, 9])
    # the colour head trained: its features and its decoder's output bias moved
    assert np.abs(np_(color.features) - cf).max() > 1e-3
    assert np.abs(np_(tcol.out.bias) - np_(jcol.out[1])).max() > 1e-4

