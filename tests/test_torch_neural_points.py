"""pin_slam_torch neural point map against the JAX package on the CPU:
insert / local map / probes / kNN / interpolation / write-back, in both the
brick (2,2,1) and the per-cell hash layouts.  Integer results (hash rows,
member masks, counts, kNN indices with their tie-breaks) must match exactly;
the row payloads are copies, so they match exactly too."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jn

torch.set_num_threads(1)


def _scene(rng):
    """Two frames of points with negative coordinates, duplicates and exact
    voxel-boundary ties."""
    a = rng.uniform(-6, 6, size=(2500, 3)).astype(np.float32)
    a[:40] = np.round(a[:40] / 0.3) * 0.3            # on voxel boundaries
    b = np.concatenate([a[:600] + rng.normal(0, 0.05, (600, 3)).astype(np.float32),
                        rng.uniform(-9, 3, size=(900, 3)).astype(np.float32)])
    return a, b


@pytest.fixture(scope="module", params=["brick", "cell"])
def maps(request):
    rng = np.random.default_rng(3)
    over = dict(map_capacity=1 << 14, local_map_capacity=1 << 12, buffer_size=1 << 18,
                downsample_hash_size=1 << 16, local_map_radius=7.0, max_range=5.0)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    if request.param == "cell":
        jmc, tmc = dataclasses.replace(jmc, brick=(1, 1, 1)), dataclasses.replace(tmc, brick=(1, 1, 1))
    assert jmc.local_hash_size == tmc.local_hash_size and jmc.nsub == tmc.nsub
    a, b = _scene(rng)
    travel = np.zeros((64,), np.float32)
    travel[1] = 3.0
    js, ts_ = jn.init_map_state(jmc), tn.init_map_state(tmc)
    for fid, pts in ((0, a), (1, b)):
        valid = rng.random(pts.shape[0]) > 0.05
        js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.asarray(valid), jnp.int32(fid),
                           jnp.asarray(travel), downsample_table_size=jcfg.downsample_hash_size,
                           insert_bucket=1024)
        ts_ = tn.map_insert(ts_, tmc, torch.as_tensor(pts), torch.as_tensor(valid), fid,
                            torch.as_tensor(travel), downsample_table_size=tcfg.downsample_hash_size,
                            insert_bucket=1024)
    origin = np.asarray([0.5, -0.25, 0.0], np.float32)
    jlm = jn.build_local_map(js, jmc, jnp.asarray(origin), jnp.int32(1), jnp.asarray(travel))
    tlm = tn.build_local_map(ts_, tmc, torch.as_tensor(origin), 1, torch.as_tensor(travel))
    q = rng.uniform(-6, 6, size=(700, 3)).astype(np.float32)
    q[:30] = a[:30]                                    # queries ON map points (ties)
    return dict(jcfg=jcfg, jmc=jmc, tmc=tmc, js=js, ts=ts_, jlm=jlm, tlm=tlm, q=q,
                travel=travel, layout=request.param)


def test_insert_matches(maps):
    js, ts_ = maps["js"], maps["ts"]
    assert int(ts_.count) == int(js.count) > 0
    np.testing.assert_array_equal(np_(ts_.hash_table), np_(js.hash_table))
    np.testing.assert_array_equal(np_(ts_.attr_rows), np_(js.attr_rows))
    np.testing.assert_array_equal(np_(ts_.geo_features), np_(js.geo_features))


def test_local_map_matches(maps):
    jlm, tlm = maps["jlm"], maps["tlm"]
    assert int(tlm.count) == int(jlm.count) > 0
    for f in ("indices", "member_mask", "lo1", "lo2", "hash_rows", "attr_rows", "origin"):
        np.testing.assert_array_equal(np_(getattr(tlm, f)), np_(getattr(jlm, f)), err_msg=f)
    empty = tn.init_local_map(maps["tmc"])
    np.testing.assert_array_equal(np_(empty.hash_rows), np_(jn.init_local_map(maps["jmc"]).hash_rows))


def test_probes_and_knn_match(maps):
    jmc, tmc, jlm, tlm, q = maps["jmc"], maps["tmc"], maps["jlm"], maps["tlm"], maps["q"]
    cfg = maps["jcfg"]
    offs = jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
    tq, jq = torch.as_tensor(q), jnp.asarray(q)
    # the JAX package runs these inside jitted programs (where division by a
    # constant becomes a multiply by its reciprocal): compare against that
    jr = jax.jit(jn.knn_search, static_argnums=1)(jlm, jmc, jq, jnp.asarray(offs))
    tr = tn.knn_search(tlm, tmc, tq, torch.as_tensor(offs))
    np.testing.assert_array_equal(np_(tr.lidx), np_(jr.lidx))
    np.testing.assert_array_equal(np_(tr.nn_count), np_(jr.nn_count))
    np.testing.assert_array_equal(np_(tn.query_certainty(tlm, tmc, tq)),
                                  np_(jax.jit(jn.query_certainty, static_argnums=1)(jlm, jmc, jq)))
    if maps["layout"] == "brick":
        jt = jn.make_probe_template(jmc, cfg.num_nei_cells, cfg.search_alpha)
        tt = tn.make_probe_template(tmc, cfg.num_nei_cells, cfg.search_alpha)
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(np_(a), np_(b))
        np.testing.assert_array_equal(np_(tn.brick_gather_fm(tlm, tmc, tt, tq)),
                                      np_(jax.jit(jn.brick_gather_fm, static_argnums=1)(
                                          jlm, jmc, jt, jq)))
    # IDW interpolation: float32 elementwise math, same operation order
    for wf in (True, False):
        jm, tm = dataclasses.replace(jmc, weighted_first=wf), dataclasses.replace(tmc, weighted_first=wf)
        jg, _, jw, jc = jax.jit(jn.interpolate_features, static_argnums=1)(
            jlm, jm, jq, jr.lidx)
        tg, tw, tc = tn.interpolate_features(tlm, tm, tq, tr.lidx)
        for a, b in ((tg, jg), (tw, jw), (tc, jc)):
            np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-6)


def test_exact_k_min_ties():
    rng = np.random.default_rng(0)
    d = np.round(rng.random((200, 33)) * 4).astype(np.float32)   # many exact ties
    d[:5] = 9e3
    np.testing.assert_array_equal(np_(tn.exact_k_min(torch.as_tensor(d), 6)),
                                  np_(jn.exact_k_min(jnp.asarray(d), 6)))


def test_assign_local_to_global_matches(maps):
    jmc, tmc, jlm, tlm = maps["jmc"], maps["tmc"], maps["jlm"], maps["tlm"]
    rng = np.random.default_rng(9)
    L = tmc.local_capacity
    feats = rng.normal(size=(L + 1, tmc.feature_dim)).astype(np.float32)
    cert = rng.random(L + 1).astype(np.float32)
    tsu = np.full((L + 1,), 1.0, np.float32)
    attr = np_(tlm.attr_rows).copy()
    attr[:, tn.C_CERT] += cert
    attr[:, tn.C_TSU] = tsu
    jlm2 = jlm._replace(geo_features=jnp.asarray(feats), attr_rows=jnp.asarray(attr))
    tlm2 = dataclasses.replace(tlm, geo_features=torch.as_tensor(feats),
                               attr_rows=torch.as_tensor(attr))
    travel = maps["travel"]
    js2 = jn.assign_local_to_global(jax_copy(maps["js"]), jlm2, jmc, jnp.asarray(travel))
    ts2 = tn.assign_local_to_global(torch_copy(maps["ts"]), tlm2, tmc, torch.as_tensor(travel))
    np.testing.assert_array_equal(np_(ts2.attr_rows), np_(js2.attr_rows))
    np.testing.assert_array_equal(np_(ts2.geo_features), np_(js2.geo_features))
    st = tn.state_from_numpy(js2)
    np.testing.assert_array_equal(np_(st.hash_table), np_(js2.hash_table))
    lm = tn.local_map_from_numpy(jlm2)
    np.testing.assert_array_equal(np_(lm.member_mask), np_(jlm2.member_mask))


def jax_copy(state):
    return state._replace(attr_rows=jnp.array(state.attr_rows),
                          geo_features=jnp.array(state.geo_features))


def torch_copy(state):
    return dataclasses.replace(state, attr_rows=state.attr_rows.clone(),
                               geo_features=state.geo_features.clone())
