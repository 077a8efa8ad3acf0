"""Positional encoding of the offset vectors (pin_slam_torch/ops/encodings.py)
and the feature interpolation that reads it and the feature layer-norm
(``neural_points.interpolate_features``), against the JAX package on the
CPU.  Encoders: elementwise float32 math in the same order, compared within
1e-6 (the sine/cosine of the same float32 argument; the Gaussian
projection is a matrix product of width 3).  Interpolation: the JAX
function jitted, as its callers run it, compared within rtol 1e-5 / atol
1e-5 (the layer-norm divides by a standard deviation taken in another
order); after a pose-graph optimisation the two packages' quaternion
rotations of the offset vectors round differently (a few float32 ulps of a
vector under 1 m), which an encoder amplifies by its largest angular
frequency w (pi * freq / 2 for the NeRF ladder, 2 pi max_j sum_i |B_ij|
for the Gaussian projection), so there atol is 1e-5 + 4e-7 w."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.ops import encodings as tenc
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.ops import encodings as jenc

torch.set_num_threads(1)


@pytest.mark.parametrize("bands, freq, base", [(4, 200.0, 2.0), (8, 50.0, 2.0),
                                               (3, 200.0, 10.0)])
def test_nerf_encoding_matches(bands, freq, base):
    x = (np.random.default_rng(bands).standard_normal((64, 6, 3)) * 0.3).astype(np.float32)
    ref = jax.jit(lambda v: jenc.positional_encode(v, bands, freq, base, False))(jnp.asarray(x))
    out = tenc.positional_encode(torch.as_tensor(x), bands, freq, base, False)
    assert out.shape == (64, 6, tenc.encoded_dim(3, bands, False)) == ref.shape
    np.testing.assert_allclose(np_(out), np_(ref), rtol=0, atol=1e-6)


def test_gaussian_encoding_matches():
    x = (np.random.default_rng(16).standard_normal((64, 6, 3)) * 0.01).astype(np.float32)
    ref = jax.jit(lambda v: jenc.positional_encode(v, 16, 200.0, 2.0, True))(jnp.asarray(x))
    out = tenc.positional_encode(torch.as_tensor(x), 16, 200.0, 2.0, True)
    assert out.shape == (64, 6, 35) == ref.shape
    np.testing.assert_array_equal(tenc._gaussian_B(3, 16, 200.0, 42),
                                  jenc._gaussian_B(3, 16, 200.0, 42))
    np.testing.assert_allclose(np_(out), np_(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bands, gaussian", [(0, False), (0, True), (1, False), (4, False),
                                             (16, True), (5, True)])
def test_encoded_dim_matches(bands, gaussian):
    for d in (1, 3, 10):
        assert tenc.encoded_dim(d, bands, gaussian) == jenc.encoded_dim(d, bands, gaussian)


def test_band_zero_is_the_identity():
    x = torch.randn(5, 3)
    assert tenc.positional_encode(x, 0, 200.0, 2.0, False) is x
    assert tenc.encoder(0, 200.0, 2.0, True) is None


@pytest.fixture(scope="module")
def maps():
    """A two-frame map built by the JAX package and copied into the port,
    with random features and random unit quaternions (a deformed map)."""
    rng = np.random.default_rng(4)
    over = dict(map_capacity=1 << 14, local_map_capacity=1 << 12, buffer_size=1 << 18,
                downsample_hash_size=1 << 16, local_map_radius=7.0, max_range=5.0)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    travel = np.zeros((64,), np.float32)
    js = jn.init_map_state(jmc)
    for fid in (0, 1):
        pts = rng.uniform(-6, 6, size=(2500, 3)).astype(np.float32)
        js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.ones(2500, bool), jnp.int32(fid),
                           jnp.asarray(travel), downsample_table_size=jcfg.downsample_hash_size,
                           insert_bucket=1024)
    origin = np.zeros(3, np.float32)
    jlm = jn.build_local_map(js, jmc, jnp.asarray(origin), jnp.int32(1), jnp.asarray(travel))
    L = jmc.local_capacity
    feats = rng.normal(size=(L + 1, jmc.feature_dim)).astype(np.float32)
    feats[7] = 0.25                                  # a row of equal values
    attr = np.array(jlm.attr_rows)
    q = rng.normal(size=(L + 1, 4)).astype(np.float32)
    attr[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    jlm = jlm._replace(geo_features=jnp.asarray(feats), attr_rows=jnp.asarray(attr))
    tlm = tn.local_map_from_numpy(jlm)
    cnt = int(jlm.count)
    near = attr[rng.integers(0, cnt, 600), :3]
    pts = (near + rng.normal(0, 0.2, near.shape)).astype(np.float32)
    offs = jn.neighbor_offsets(jcfg.num_nei_cells, jcfg.search_alpha)
    knn = jax.jit(jn.knn_search, static_argnums=1)(jlm, jmc, jnp.asarray(pts), jnp.asarray(offs))
    assert int((np.asarray(knn.lidx) < L).sum()) > 800
    return dict(jmc=jmc, tmc=tmc, jlm=jlm, tlm=tlm, pts=pts, lidx=np.asarray(knn.lidx))


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
@pytest.mark.parametrize("enc", [dict(), dict(pos_encoding_band=4),
                                 dict(pos_encoding_band=16, use_gaussian_pe=True)],
                         ids=["none", "nerf4", "gauss16"])
@pytest.mark.parametrize("ln", [False, True], ids=["raw", "layer_norm"])
@pytest.mark.parametrize("after_pgo", [False, True], ids=["", "after_pgo"])
def test_interpolate_features_matches(maps, wf, enc, ln, after_pgo):
    over = dict(weighted_first=wf, layer_norm_on=ln, **enc)
    jmc = dataclasses.replace(maps["jmc"], **over)
    tmc = dataclasses.replace(maps["tmc"], **over)
    pts, lidx = maps["pts"], maps["lidx"]
    jg, _, jw, jc = jax.jit(jn.interpolate_features, static_argnums=(1, 4))(
        maps["jlm"], jmc, jnp.asarray(pts), jnp.asarray(lidx), after_pgo)
    tg, tw, tc = tn.interpolate_features(maps["tlm"], tmc, torch.as_tensor(pts),
                                         torch.as_tensor(lidx).to(torch.int64),
                                         after_pgo=after_pgo)
    assert tg.shape[-1] == tmc.feature_dim + tmc.vec_dim == jg.shape[-1]
    w_max = 0.0
    if after_pgo and enc.get("use_gaussian_pe"):
        w_max = 2 * np.pi * np.abs(tenc._gaussian_B(3, 16, tmc.pos_encoding_freq, 42)).sum(0).max()
    elif after_pgo and enc:
        w_max = np.pi * tmc.pos_encoding_freq / 2
    for a, b in ((tg, jg), (tw, jw), (tc, jc)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-5 + 4e-7 * w_max)
