"""The port's ``prune_map`` against the JAX package's on the CPU: the same
map (inserts over four frames along a travelled path, certainties drawn
from a seed) pruned at two thresholds and two frames; the tombstoned rows
(the keep mask) and every attribute row must match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def states():
    base = dict(map_capacity=1 << 13, local_map_capacity=1 << 11, buffer_size=1 << 16,
                downsample_hash_size=1 << 14, max_range=8.0)
    jcfg, tcfg = small_config(JConfig, **base), small_config(TConfig, **base)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    rng = np.random.default_rng(4)
    travel = np.zeros((64,), np.float32)
    travel[1:8] = np.cumsum(np.full(7, 0.4 * tmc.travel_dist_window, np.float32))
    js, ts_ = jn.init_map_state(jmc), tn.init_map_state(tmc)
    for fid in range(4):
        pts = rng.uniform(-4, 4, size=(900, 3)).astype(np.float32) + np.float32([3 * fid, 0, 0])
        valid = rng.random(900) > 0.05
        js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.asarray(valid), jnp.int32(fid),
                           jnp.asarray(travel), downsample_table_size=jcfg.downsample_hash_size,
                           insert_bucket=1024)
        ts_ = tn.map_insert(ts_, tmc, torch.as_tensor(pts), torch.as_tensor(valid), fid,
                            torch.as_tensor(travel),
                            downsample_table_size=tcfg.downsample_hash_size, insert_bucket=1024)
    n = int(ts_.count)
    assert n == int(js.count) > 2000
    cert = np.zeros((tmc.capacity + 1,), np.float32)
    cert[:n] = rng.uniform(0, 10, n)
    js = js._replace(attr_rows=js.attr_rows.at[:, 7].set(jnp.asarray(cert)))
    ts_.attr_rows[:, 7] = torch.as_tensor(cert)
    np.testing.assert_array_equal(np_(ts_.attr_rows), np_(js.attr_rows))
    return dict(jmc=jmc, tmc=tmc, js=js, ts=ts_, travel=travel, n=n)


@pytest.mark.parametrize("cur_ts, thre", [(3, 5.0), (7, 2.0)], ids=["frame3", "frame7"])
def test_prune_map_matches(states, cur_ts, thre):
    s = states
    before = np_(s["ts"].attr_rows).copy()
    jout = jn.prune_map(s["js"], s["jmc"], jnp.asarray(s["travel"]), jnp.int32(cur_ts),
                        prune_certainty_thre=thre)
    tout = tn.prune_map(s["ts"], s["tmc"], torch.as_tensor(s["travel"]), cur_ts, thre)
    np.testing.assert_array_equal(np_(tout.attr_rows), np_(jout.attr_rows))
    keep_t = np_(tout.attr_rows)[:, 0] < 1e7
    keep_j = np_(jout.attr_rows)[:, 0] < 1e7
    np.testing.assert_array_equal(keep_t, keep_j)
    n = s["n"]
    pruned = int((~keep_t[:n]).sum())
    assert 0 < pruned < n                                   # some pruned, some kept
    # tombstoned in place: the count, features and hash stay; the input is untouched
    assert int(tout.count) == n
    assert tout.geo_features is s["ts"].geo_features
    np.testing.assert_array_equal(np_(s["ts"].attr_rows), before)
    np.testing.assert_array_equal(np_(tout.attr_rows)[:, 3:], before[:, 3:])
