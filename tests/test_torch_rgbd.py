"""The port's RGB-D colour path against the JAX package's on the CPU: the
coloured frames' preprocessing, the sampler's colour labels, the pool's
colour labels through append and filter, the map's colour features through
insert / local map / write-back / finalisation, colour interpolation and the
colour head (clip included), the colour loss, one call of the colour
training loop, the colour tracker (photometric rows, or the
intensity-consistency weight), vertex painting, the saved map with colour,
and the slice end to end (SlamSystem frame by frame from synced state).

Integers and copied rows must match exactly.  Float tolerances are stated
at each test: interpolation and the head rtol 1e-5 / atol 1e-6; the loss
rtol 1e-6; the training loop's loss history rtol 1e-4 and its parameters
within 1e-4 of each leaf's largest magnitude (Adam with eps 1e-15 turns
rounding-level gradient differences into step-size ones); the tracker the
same iteration count and stop flags and a pose within 1e-4 m / 1e-5 rad;
painting atol 1e-5."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_rgbd import make_rgbd_dataset
from torch_port_util import np_, pack_jax_decoder, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import decoder as tdec
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.ops import losses as tlosses
from pin_slam_torch.slam import mapper as tm
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.ops import losses as jlosses
from pin_slam_tpu.slam import mapper as jm

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOR = dict(color_map_on=True, color_on=True, color_channel=3)


def _cfgs(**over):
    base = dict(COLOR, map_capacity=1 << 14, local_map_capacity=1 << 12, buffer_size=1 << 18,
                downsample_hash_size=1 << 16, max_range=5.0)
    base.update(over)
    return small_config(JConfig, **base), small_config(TConfig, **base)


def _color_decoder_pair(seed, bias_shift=0.0):
    """A JAX colour DecoderParams (11 -> 64 -> 3) and the port's Decoder
    with the same weights; ``bias_shift`` moves the output bias so that
    part of the predictions clip."""
    p = jdec.init_decoder(jax.random.PRNGKey(seed), 11, 64, 1, 3)
    W, b = p.out
    p = p._replace(out=(W * 4.0, b + bias_shift))
    return p, tdec.decoder_from_jax(p)


# ----------------------------------------------------------------------
# frames, sampler, pool
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def rgbd_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rgbd") / "seq")
    make_rgbd_dataset(root, np.random.default_rng(42), n_frames=4)
    return root


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_range", "adaptive_range"])
def test_preprocess_frame_carries_colours(rgbd_seq, adaptive):
    """Crop, random downsample and the bucket cap keep each point's colour;
    colours are kept only with color_on."""
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset
    from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset

    over = dict(pc_path=f"{rgbd_seq}/rgbd_ply", pose_path=f"{rgbd_seq}/poses.txt",
                min_range=0.2, max_range=4.0, frame_bucket=1 << 13,
                adaptive_range_on=adaptive, rand_downsample=True, rand_down_r=0.9)
    jcfg, tcfg = _cfgs(**over)
    jd, td = JDataset(jcfg), TDataset(tcfg)
    for i in (0, 3):
        jf, tf = jd.preprocess_frame(i), td.preprocess_frame(i)
        assert tf.raw_count == jf.raw_count and tf.colors is not None
        for a, b in ((tf.points, jf.points), (tf.valid, jf.valid), (tf.colors, jf.colors)):
            np.testing.assert_array_equal(a, b)
        assert 0 < tf.raw_count <= 1 << 13 and tf.colors[: tf.raw_count].max() > 0.5
    tcfg.color_on = False
    assert TDataset(tcfg).preprocess_frame(0).colors is None


def test_sample_rays_colour_labels():
    from pin_slam_torch.ops.sampler import SamplerConfig as TSc, sample_rays as tsample
    from pin_slam_tpu.ops.sampler import SamplerConfig as JSc, sample_rays as jsample

    jcfg, tcfg = _cfgs()
    jsc, tsc = JSc.from_config(jcfg), TSc.from_config(tcfg)
    rng = np.random.default_rng(1)
    n = 300
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.2
    col = rng.random((n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jb = jsample(key, jsc, jnp.asarray(pts), jnp.asarray(valid), None, jnp.asarray(col))
    k_surf, k_front, k_behind = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(d)) for d in (
        jax.random.normal(k_surf, (n, jsc.surface_sample_n)),
        jax.random.uniform(k_front, (n, jsc.free_front_n)),
        jax.random.uniform(k_behind, (n, jsc.free_behind_n))))
    tb = tsample(tsc, torch.as_tensor(pts), torch.as_tensor(valid), draws, torch.as_tensor(col))
    np.testing.assert_array_equal(np_(tb.color_label), np_(jb.color_label))
    np.testing.assert_array_equal(np_(tb.valid), np_(jb.valid))
    S = tsc.ray_sample_count
    lab = np_(tb.color_label).reshape(n, S, 3)
    assert (lab[:, 0] == col).all() and not lab[:, 1 + tsc.surface_sample_n:].any()


def test_pool_append_and_filter_move_colour_labels():
    """Two frames appended (the second past the ring's end, so the head
    wraps) and a window filter: colour labels follow their rows."""
    jcfg, tcfg = _cfgs(pool_capacity=1 << 10)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    jp, tp = jm.init_pool(jmcfg, color_channel=3), tm.init_pool(tmcfg, color_channel=3)
    rng = np.random.default_rng(2)
    for fid, n in ((1, 700), (2, 600)):
        coord = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
        label = rng.normal(0, 0.2, n).astype(np.float32)
        weight = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
        valid = rng.random(n) > 0.3
        new_mask = rng.random(n) > 0.6
        gidx = rng.integers(-1, 500, (n, 6)).astype(np.int32)
        w = rng.random((n, 6)).astype(np.float32)
        vec = rng.normal(size=(n, 3)).astype(np.float32)
        col = rng.random((n, 3)).astype(np.float32)
        jp = jm.pool_append(jp, jmcfg, jnp.asarray(coord), jnp.asarray(coord) - 1.0,
                            jnp.asarray(label), jnp.asarray(weight), jnp.asarray(valid),
                            jnp.int32(fid), jnp.asarray(new_mask), None, jnp.asarray(col),
                            jnp.asarray(gidx), jnp.asarray(w), jnp.asarray(vec))
        tp = tm.pool_append(tp, tmcfg, torch.as_tensor(coord), torch.as_tensor(coord) - 1.0,
                            torch.as_tensor(label), torch.as_tensor(weight),
                            torch.as_tensor(valid), fid, torch.as_tensor(new_mask),
                            torch.as_tensor(gidx), torch.as_tensor(w), torch.as_tensor(vec),
                            color_label=torch.as_tensor(col))
        np.testing.assert_array_equal(np_(tp.color_label), np_(jp.color_label))
        np.testing.assert_array_equal(np_(tp.rows)[:, :15], np_(jp.rows)[:, :15])
        assert int(tp.head) == int(jp.head) and int(tp.fill) == int(jp.fill)
    origin = np.asarray([1.0, 0.5, 0.0], np.float32)
    mcfg_j = dataclasses.replace(jmcfg, window_radius=3.0)
    mcfg_t = dataclasses.replace(tmcfg, window_radius=3.0)
    jf = jm.pool_filter(jp, mcfg_j, jnp.asarray(origin))
    tf = tm.pool_filter(tp, mcfg_t, torch.as_tensor(origin))
    assert 0 < int(tf.fill) == int(jf.fill) < int(jp.fill)
    np.testing.assert_array_equal(np_(tf.color_label), np_(jf.color_label))
    np.testing.assert_array_equal(np_(tf.rows)[:, :15], np_(jf.rows)[:, :15])
    assert tm.pool_from_numpy(jf).color_label is not None


# ----------------------------------------------------------------------
# the map's colour features
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def colour_maps():
    """Both packages' maps after two inserts over a table whose colour rows
    start random (inserted rows must become 0), and their local maps."""
    rng = np.random.default_rng(3)
    jcfg, tcfg = _cfgs()
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    assert jmc.color_on and tmc.color_on
    cap, F = tmc.capacity, tmc.feature_dim
    c0 = rng.normal(size=(cap + 1, F)).astype(np.float32)
    js = jn.init_map_state(jmc)._replace(color_features=jnp.asarray(c0))
    ts_ = tn.init_map_state(tmc)
    ts_.color_features = torch.as_tensor(c0.copy())
    travel = np.zeros((64,), np.float32)
    travel[1] = 3.0
    a = rng.uniform(-5, 5, size=(2500, 3)).astype(np.float32)
    b = np.concatenate([a[:600] + rng.normal(0, 0.05, (600, 3)).astype(np.float32),
                        rng.uniform(-8, 3, size=(900, 3)).astype(np.float32)])
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
    return dict(jcfg=jcfg, jmc=jmc, tmc=tmc, js=js, ts=ts_, jlm=jlm, tlm=tlm, travel=travel,
                c0=c0)


def test_map_insert_and_local_map_colour_rows(colour_maps):
    m = colour_maps
    js, ts_ = m["js"], m["ts"]
    n = int(ts_.count)
    assert n == int(js.count) > 1000
    np.testing.assert_array_equal(np_(ts_.color_features), np_(js.color_features))
    assert not np_(ts_.color_features)[:n].any()              # inserted rows start at 0
    np.testing.assert_array_equal(np_(ts_.color_features)[n:], m["c0"][n:])
    np.testing.assert_array_equal(np_(m["tlm"].color_features), np_(m["jlm"].color_features))
    lm = tn.local_map_from_numpy(m["jlm"])
    np.testing.assert_array_equal(np_(lm.color_features), np_(m["jlm"].color_features))


def _trained_local(m, seed):
    """Both local maps with the same random colour features."""
    L, F = m["tmc"].local_capacity, m["tmc"].feature_dim
    cf = np.random.default_rng(seed).normal(size=(L + 1, F)).astype(np.float32)
    return (m["jlm"]._replace(color_features=jnp.asarray(cf)),
            dataclasses.replace(m["tlm"], color_features=torch.as_tensor(cf)), cf)


def test_assign_and_finalize_move_colour_rows(colour_maps):
    m = colour_maps
    jlm, tlm, _ = _trained_local(m, 4)
    js = jax.tree.map(jnp.array, m["js"])              # the write-back donates its input
    ts_ = dataclasses.replace(m["ts"], **{f: getattr(m["ts"], f).clone()
                                          for f in ("attr_rows", "geo_features",
                                                    "color_features")})
    travel = m["travel"]
    js2 = jn.assign_local_to_global(js, jlm, m["jmc"], jnp.asarray(travel))
    ts2 = tn.assign_local_to_global(ts_, tlm, m["tmc"], torch.as_tensor(travel))
    np.testing.assert_array_equal(np_(ts2.color_features), np_(js2.color_features))
    n = int(ts2.count)
    assert np_(ts2.color_features)[:n].any()
    st = tn.state_from_numpy(js2)
    np.testing.assert_array_equal(np_(st.color_features), np_(js2.color_features))
    attr = np_(js2.attr_rows).copy()
    attr[: n // 2, jn.C_CERT] = 10.0                         # half certain, half pruned
    js3 = js2._replace(attr_rows=jnp.asarray(attr))
    ts3 = tn.state_from_numpy(js3)
    jf = jn.finalize_map(js3, m["jmc"], jnp.asarray(travel * 0 + np.arange(64) * 4.0),
                         jnp.int32(40), prune_certainty_thre=2.0,
                         downsample_table_size=1 << 16)
    tf = tn.finalize_map(ts3, m["tmc"], torch.as_tensor(travel * 0 + np.arange(64) * 4.0), 40,
                         prune_certainty_thre=2.0, downsample_table_size=1 << 16)
    assert 0 < int(tf.count) == int(jf.count) < n
    for f in ("attr_rows", "geo_features", "color_features", "hash_table"):
        np.testing.assert_array_equal(np_(getattr(tf, f)), np_(getattr(jf, f)), err_msg=f)


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_colour_interpolation_and_head(colour_maps, wf):
    """interpolate_features(query_color=True) and blended_head(regress_color)
    at map points, near them and far from any (no neighbour); the decoder's
    output bias pushes part of the predictions past 0 and 1 (clipped)."""
    m = colour_maps
    jlm, tlm, _ = _trained_local(m, 5)
    jmc = dataclasses.replace(m["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(m["tmc"], weighted_first=wf)
    rng = np.random.default_rng(6)
    pos = np_(tlm.positions)[: int(tlm.count)]
    q = np.concatenate([pos[:200] + rng.normal(0, 0.1, (200, 3)), pos[200:260],
                        np.full((5, 3), 40.0)]).astype(np.float32)
    cfg = m["jcfg"]
    offs = jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jk = jax.jit(jn.knn_search, static_argnums=1)(jlm, jmc, jq, jnp.asarray(offs))
    tk = tn.knn_search(tlm, tmc, tq, torch.as_tensor(offs))
    np.testing.assert_array_equal(np_(tk.lidx), np_(jk.lidx))
    jg, jc, jw, jcert = jax.jit(jn.interpolate_features, static_argnums=(1,),
                                static_argnames=("query_color",))(jlm, jmc, jq, jk.lidx,
                                                                  query_color=True)
    tg, tc_, tw, tcert = tn.interpolate_features(tlm, tmc, tq, tk.lidx, query_color=True)
    for a, b in ((tg, jg), (tc_, jc), (tw, jw), (tcert, jcert)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-6)
    jp, tp = _color_decoder_pair(7, bias_shift=0.5)
    jpred = jax.jit(lambda p, c, w: jdec.blended_head(jdec.regress_color, p, c, w, wf))(
        jp, jc, jw)
    tpred = tdec.blended_head(tdec.regress_color, tp, tc_, tw, wf)
    np.testing.assert_allclose(np_(tpred), np_(jpred), rtol=1e-5, atol=1e-6)
    per = np_(tdec.regress_color(tp, tc_))
    assert (per == 0.0).any() and (per == 1.0).any() and ((per > 0) & (per < 1)).any()


def test_colour_clip_splits_the_gradient_at_its_ends_as_jax_does():
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    jg = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x)))
    t = torch.as_tensor(x).requires_grad_(True)
    tdec.clip01(t).sum().backward()
    np.testing.assert_array_equal(np_(t.grad), jg)
    assert jg[1] == 0.5 and jg[3] == 0.5


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_color_diff_loss_matches(l2, weighted):
    rng = np.random.default_rng(8)
    pred, label = (rng.random((500, 3)).astype(np.float32) for _ in range(2))
    weight = rng.uniform(0.2, 1.4, 500).astype(np.float32)
    valid = rng.random(500) > 0.3
    j = jlosses.color_diff_loss(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(weight),
                                weighted, l2, valid=jnp.asarray(valid))
    t = tlosses.color_diff_loss(torch.as_tensor(pred), torch.as_tensor(label),
                                torch.as_tensor(weight), weighted, l2,
                                valid=torch.as_tensor(valid))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    j0 = jlosses.color_diff_loss(jnp.asarray(pred), jnp.asarray(label), None, weighted, l2)
    t0 = tlosses.color_diff_loss(torch.as_tensor(pred), torch.as_tensor(label), None,
                                 weighted, l2)
    np.testing.assert_allclose(float(t0), float(j0), rtol=1e-6)


# ----------------------------------------------------------------------
# vertex painting and the saved map
# ----------------------------------------------------------------------


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_paint_vertices_matches(colour_maps, wf):
    """The port's Mesher.paint_vertices against the JAX Mesher's
    _paint_vertices (query buckets of 64, so the last one is padded)."""
    from pin_slam_torch.slam.mesher import Mesher as TMesher, MesherConfig as TMc
    from pin_slam_tpu.slam.mesher import Mesher as JMesher, MesherConfig as JMc

    m = colour_maps
    jlm, tlm, _ = _trained_local(m, 9)
    jmc = dataclasses.replace(m["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(m["tmc"], weighted_first=wf)
    cfg = m["jcfg"]
    offs = jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
    pos = np_(tlm.positions)[: int(tlm.count)]
    verts = (pos[:300] + np.random.default_rng(10).normal(0, 0.1, (300, 3))).astype(np.float32)
    jp, tp = _color_decoder_pair(11, bias_shift=0.3)
    geo = jdec.init_decoder(jax.random.PRNGKey(12), 11, 64, 1, 1)
    jc, _ = JMesher(JMc(query_bucket=64, color_on=True), jmc, jnp.asarray(offs))._paint_vertices(
        jlm, geo, jp, None, 1.0, verts)
    tc_ = TMesher(TMc(query_bucket=64, color_on=True), tmc, torch.as_tensor(offs)).paint_vertices(
        tlm, tp, verts)
    assert tc_.shape == (300, 3) and tc_.dtype == np.float32
    np.testing.assert_allclose(tc_, jc, atol=1e-5)
    assert tc_.min() >= 0.0 and tc_.max() <= 1.0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_map_with_colour_loads_in_the_other_package(colour_maps, writer, tmp_path):
    from pin_slam_torch.utils import experiment as texp
    from pin_slam_tpu.utils import experiment as jexp

    m = colour_maps
    js = m["js"]
    n = int(js.count)
    cf = np.random.default_rng(13).normal(size=np.asarray(js.color_features).shape)
    js = js._replace(color_features=jnp.asarray(cf.astype(np.float32)))
    ts_ = tn.state_from_numpy(js)
    geo = jdec.init_decoder(jax.random.PRNGKey(14), 11, 64, 1, 1)
    jp, tp = _color_decoder_pair(15)
    path = str(tmp_path / "pin_map.npz")
    if writer == "jax":
        jexp.save_implicit_map(path, js, geo, None, jp)
    else:
        texp.save_implicit_map(path, ts_, tdec.decoder_from_jax(geo), color_decoder=tp)
    blob = dict(np.load(path))
    assert "color_features" in blob and "decoder_color_out_W" in blob
    jst, jgeo, jsem, jcol = jexp.load_implicit_map(path, m["jmc"])
    tst, tgeo, tcol = texp.load_implicit_map(path, m["tmc"], device="cpu", color=True)
    assert jsem is None and int(tst.count) == int(jst.count) == n
    np.testing.assert_array_equal(np_(tst.color_features), np_(jst.color_features))
    np.testing.assert_array_equal(np_(tst.color_features)[:n], cf[:n].astype(np.float32))
    for (Wt, bt), (Wj, bj), (Wp, bp) in zip(tcol.layers(), list(jcol.hidden) + [jcol.out],
                                            list(jp.hidden) + [jp.out]):
        for a, b, c in ((Wt, Wj, Wp), (bt, bj, bp)):
            np.testing.assert_array_equal(np_(a), np_(b))
            np.testing.assert_array_equal(np_(a), np_(c))
    np.testing.assert_array_equal(np_(tgeo.layers()[0][0]), np_(jgeo.hidden[0][0]))
    assert len(texp.load_implicit_map(path, m["tmc"], device="cpu")) == 2


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------


def test_replica_profile_builds_and_heads_still_refused():
    """run_replica.yaml builds a SlamSystem (colour head, pool colour
    labels, photometric tracking, its 1e-3 / 1e-4 stop terms read as
    floats); the semantic head, feature layer-norm and positional encoding
    still raise naming their ROADMAP item."""
    from pin_slam_torch.slam.pipeline import SlamSystem

    def cfg_of(**over):
        cfg = TConfig().load(os.path.join(ROOT, "config", "rgbd_slam", "run_replica.yaml"))
        cfg.pc_path = cfg.pose_path = ""
        cfg.map_capacity, cfg.local_map_capacity = 1 << 12, 1 << 10
        cfg.buffer_size, cfg.pool_capacity, cfg.downsample_hash_size = 1 << 14, 1 << 12, 1 << 12
        for k, v in over.items():
            setattr(cfg, k, v)
        cfg._derive()
        return cfg

    s = SlamSystem(cfg_of(), device="cpu")
    assert s.color_decoder is not None and s.lm.color_features is not None
    assert s.pool.color_label.shape == (s.mcfg.pool_capacity + 1, 3)
    assert s.tc.photometric_on and s.tc.photometric_weight == pytest.approx(0.01)
    assert s.tc.term_thre_deg == pytest.approx(1e-3) and s.tc.term_thre_m == pytest.approx(1e-4)
    for over, label in ((dict(semantic_on=True), "ROADMAP A 11"),
                        (dict(layer_norm_on=True), "layer_norm_on"),
                        (dict(pos_encoding_band=4), "pos_encoding_band")):
        with pytest.raises(NotImplementedError, match=label):
            SlamSystem(cfg_of(**over), device="cpu")


# ----------------------------------------------------------------------
# the colour training loop
# ----------------------------------------------------------------------


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_colour_mapping_loop_matches(colour_maps, wf):
    """One call of mapping_loop_cached with the colour head (T = 3) from the
    same state and batch indices: the port's kernel path (plain twins on
    the CPU) with the colour term beside it against the JAX package's
    autodiff loop (use_kernel=False).  Loss history rtol 1e-4; every
    trained leaf (geometry features, packed SDF decoder, colour features,
    colour decoder) within 1e-4 of its largest magnitude; the certainty
    column as tests/test_torch_mapper.py holds it."""
    m = colour_maps
    jcfg, tcfg = _cfgs(bs=256, bs_new_sample=32, iters=3, weighted_first=wf,
                       pool_capacity=1 << 12)
    jmc = dataclasses.replace(m["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(m["tmc"], weighted_first=wf)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    jlm, tlm, cf = _trained_local(m, 16)
    rng = np.random.default_rng(17)
    pos = np_(tlm.positions)[: int(tlm.count)]
    S, near = 7, 4
    n_rays = 120
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
    col = rng.random((M, 3)).astype(np.float32)
    jp = jm.pool_append(jm.init_pool(jmcfg, color_channel=3), jmcfg, jnp.asarray(coords),
                        jnp.asarray(coords), jnp.asarray(label), jnp.asarray(weight),
                        jnp.ones((M,), bool), jnp.int32(1), jnp.asarray(rng.random(M) > 0.5),
                        None, jnp.asarray(col), gidx, w, vec,
                        knn_nbr_vec=None if wf else rest[0])
    L, F = tmc.local_capacity, tmc.feature_dim
    feats = np.concatenate([0.05 * rng.standard_normal((L + 1, F)), np.zeros((L + 1, 1))],
                           1).astype(np.float32)
    geo = jdec.init_decoder(jax.random.PRNGKey(18), F + 3, 64, 1, 1)
    jcol, tcol = _color_decoder_pair(19, bias_shift=0.2)
    params = jm.TrainableParams(features=jnp.asarray(feats), color_features=jnp.asarray(cf),
                                geo=geo, sem=None, color=jcol)
    key = jax.random.PRNGKey(20)
    lm_j, p_j, _, hist_j = jm.mapping_loop_cached(
        jlm, jmc, params, jm.init_opt_state(jmcfg, params), jp, jmcfg, key,
        jnp.float32(1.0), jnp.ones((), bool), num_iters=3, use_kernel=False)
    idx = torch.as_tensor(np.array(jm._sample_batch_indices(key, jp, jmcfg, jnp.ones((), bool),
                                                            3)), dtype=torch.int64)
    f0, g0 = torch.as_tensor(feats), pack_jax_decoder(geo)
    color = tm.init_color_state(torch.as_tensor(cf), tcol)
    lm_t, f_t, g_t, _, hist_t = tm.mapping_loop_cached(
        tlm, tmc, f0, g0, tm.init_opt_state(f0, g0), tm.pool_from_numpy(jp), tmcfg, idx, 1.0,
        color=color)
    np.testing.assert_allclose(np_(hist_t), np_(hist_j), rtol=1e-4)
    color.load_into(tcol)
    jcol_leaves = [np_(x) for pair in list(p_j.color.hidden) + [p_j.color.out] for x in pair]
    tcol_leaves = [np_(x) for pair in tcol.layers() for x in pair]
    leaves = [(np_(f_t), np_(p_j.features)), (np_(g_t), np_(pack_jax_decoder(p_j.geo))),
              (np_(color.features), np_(p_j.color_features))] + list(zip(tcol_leaves,
                                                                         jcol_leaves))
    for i, (a, b) in enumerate(leaves):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), err_msg=f"leaf {i}")
    np.testing.assert_allclose(np_(lm_t.attr_rows)[:, 7], np_(lm_j.attr_rows)[:, 7],
                               rtol=1e-4, atol=1e-4)
    assert np.abs(np_(color.features) - cf).max() > 1e-3          # the colour head trained
    assert np.abs(tcol_leaves[-1] - np_(jcol.out[1])).max() > 1e-4


def test_colour_gradient_graph_has_no_indexed_backward(colour_maps, monkeypatch):
    """The colour term's autograd graph starts at the gathered rows (a
    leaf) and holds no indexed gather / scatter backward (those add with
    float atomics on the card); the rows' gradient goes to the row
    scatter, which the loop calls once an iteration."""
    m = colour_maps
    _, tcol = _color_decoder_pair(21)
    rng = np.random.default_rng(22)
    B, k = 64, 6
    color = tm.init_color_state(torch.zeros(10, 8), tcol)
    seen = []
    real = torch.autograd.grad

    def spy(outputs, inputs, *a, **kw):
        from test_torch_bundle_adjustment import _graph_names

        seen.append(_graph_names(outputs.grad_fn))
        return real(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    for wf in (True, False):
        mcfg = dataclasses.replace(tm.MapperConfig.from_config(_cfgs()[1]), weighted_first=wf)
        vin = torch.as_tensor(rng.normal(size=(B, 3) if wf else (B, k, 3)).astype(np.float32))
        tm.color_loss_and_grads(color, torch.as_tensor(rng.normal(size=(B, k, 8))
                                                       .astype(np.float32)),
                                torch.as_tensor(rng.random((B, k)).astype(np.float32)), vin,
                                torch.rand(B, 3), torch.rand(B), torch.rand(B) > 0.3, mcfg)
    assert len(seen) == 2
    for names in seen:
        bad = {n for n in names if n.startswith(("Index", "Gather", "Scatter", "Embedding",
                                                 "Take", "Put"))}
        assert not bad, bad


# ----------------------------------------------------------------------
# the colour tracker and the slice end to end
# ----------------------------------------------------------------------


def _system_config(Config, root):
    """tests/test_rgbd.py's RGB-D configuration at test capacities."""
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/rgbd_ply", f"{root}/poses.txt"
    for k, v in COLOR.items():
        setattr(cfg, k, v)
    cfg.min_range, cfg.max_range = 0.2, 8.0
    cfg.min_z, cfg.max_z = -5.0, 5.0
    cfg.voxel_size_m = 0.1
    cfg.surface_sample_range_m = 0.05
    cfg.sigma_sigmoid_m = 0.02
    cfg.photometric_loss_on = True
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 12, 10
    cfg.reg_iter_n = 50
    cfg.eigenvalue_check = False
    cfg.source_vox_down_m = 0.15
    cfg.silence = True
    cfg.pgo_on = False
    cfg.map_capacity, cfg.local_map_capacity = 1 << 16, 1 << 15
    cfg.buffer_size, cfg.pool_capacity = 1 << 18, 1 << 18
    cfg.frame_bucket, cfg.source_bucket = 1 << 14, 1 << 12
    cfg.downsample_hash_size = 1 << 17
    cfg._derive()
    return cfg


@pytest.fixture(scope="module")
def trained_rgbd(rgbd_seq):
    """The port's SlamSystem after frame 0 of the coloured room (a trained
    colour map), the next frame's source cloud, and the JAX package's view
    of the same local map."""
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _system_config(TConfig, rgbd_seq)
    s = SlamSystem(cfg, device="cpu")
    s.process_frame(s.dataset.preprocess_frame(0))
    f1 = s.dataset.preprocess_frame(1)
    src, src_valid, src_col = s._source_prep(torch.as_tensor(f1.points),
                                             torch.as_tensor(f1.valid),
                                             torch.as_tensor(f1.colors))
    lm = s.lm
    jcfg = _system_config(JConfig, rgbd_seq)
    jmc = jn.MapConfig.from_config(jcfg)
    jlm = jn.LocalMap(indices=jnp.asarray(np_(lm.indices).astype(np.int32)),
                      attr_rows=jnp.asarray(np_(lm.attr_rows)),
                      geo_features=jnp.asarray(np_(lm.geo_features)),
                      color_features=jnp.asarray(np_(lm.color_features)),
                      count=jnp.int32(int(lm.count)), member_mask=jnp.asarray(np_(lm.member_mask)),
                      lo1=jnp.int32(int(lm.lo1)), lo2=jnp.int32(int(lm.lo2)),
                      origin=jnp.asarray(np_(lm.origin)), hash_rows=jnp.asarray(np_(lm.hash_rows)))

    def jparams(dec):
        layers = [(jnp.asarray(np_(W).copy()), jnp.asarray(np_(b).copy()))
                  for W, b in dec.layers()]
        return jdec.DecoderParams(hidden=tuple(layers[:-1]), out=layers[-1])

    tmpl = (jn.make_probe_template(jmc, jcfg.num_nei_cells, jcfg.search_alpha)
            if jmc.nsub > 1 else jnp.asarray(jn.neighbor_offsets(jcfg.num_nei_cells,
                                                                  jcfg.search_alpha)))
    return dict(s=s, cfg=cfg, jcfg=jcfg, jmc=jmc, jlm=jlm, jgeo=jparams(s.decoder),
                jcol=jparams(s.color_decoder), jtmpl=tmpl, src=src, src_valid=src_valid,
                src_col=src_col)


@pytest.mark.parametrize("photometric", [True, False], ids=["photometric", "consistency"])
def test_colour_track_frame_matches(trained_rgbd, photometric):
    """track_frame's colour path (a fresh kNN and autograd input gradients
    every Gauss-Newton iteration) against the JAX package's vjp path from
    the same map and initial guess, with the photometric rows, or without
    them and with the intensity-consistency weight: the same iteration
    count and stop flags, the pose within 1e-4 m / 1e-5 rad."""
    from pin_slam_torch.slam import tracker as ttrk
    from pin_slam_tpu.slam import tracker as jtrk

    d = trained_rgbd
    s = d["s"]
    jtc = dataclasses.replace(jtrk.TrackerConfig.from_config(d["jcfg"]),
                              photometric_on=photometric)
    ttc = dataclasses.replace(s.tc, photometric_on=photometric)
    assert ttc.consist_weight_on and jtc.consist_weight_on
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jr = jtrk.track_frame(d["jlm"], d["jmc"], jtc, d["jgeo"], s.sdf_scale, d["jtmpl"],
                          jnp.asarray(np_(d["src"])), jnp.asarray(np_(d["src_valid"])),
                          jnp.asarray(R0), jnp.asarray(t0), color_params=d["jcol"],
                          source_colors=jnp.asarray(np_(d["src_col"])))
    tr = ttrk.track_frame(s.lm, s.mc, ttc, s.decoder, s.sdf_scale, s.append_tmpl, d["src"],
                          d["src_valid"], torch.as_tensor(R0), torch.as_tensor(t0),
                          color_decoder=s.color_decoder, source_colors=d["src_col"])
    assert (tr.iterations, tr.converged, tr.valid) == (int(jr.iterations), bool(jr.converged),
                                                       bool(jr.valid))
    assert tr.valid and tr.iterations > 2
    assert np.abs(np_(tr.t) - np_(jr.t)).max() < 1e-4, (np_(tr.t), np_(jr.t))
    # the angle of R_t^T R_j from its skew part: arccos of the trace would
    # read the float32 rotations' ~1e-8 scale error as ~1e-4 rad
    dR = np_(tr.R).astype(np.float64).T @ np_(jr.R).astype(np.float64)
    skew = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    assert np.arcsin(min(np.linalg.norm(skew), 1.0)) < 1e-5
    assert tr.valid_count == int(jr.valid_count)
    assert (tr.photo_count > 0) == photometric


def _sync_colour(tsys, jsys):
    from test_torch_pipeline import _sync_from_jax

    from pin_slam_torch.models.decoder import params_from_jax

    _sync_from_jax(tsys, jsys)
    tsys.color_decoder.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                                    jsys.color_params)))
    assert tsys.state.color_features is not None and tsys.pool.color_label is not None


def test_rgbd_slice_matches_jax(rgbd_seq):
    """The slice end to end: the port's SlamSystem against the JAX
    package's on 4 frames of the coloured room, each frame from the JAX
    system's state (map and colour features, local map, pool and colour
    labels, both decoders, pose books) with the JAX package's random draws,
    held as tests/test_torch_pipeline.py holds the main path: every frame
    registers in both, poses within 2 cm / 0.2 deg, map and pool sizes
    within 5 %, finite losses."""
    from test_torch_pipeline import JaxDraws

    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    jsys = JSlam(_system_config(JConfig, rgbd_seq))
    tcfg = _system_config(TConfig, rgbd_seq)
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    assert jsys.color_params is not None and tsys.color_decoder is not None
    for i in range(4):
        _sync_colour(tsys, jsys)
        j_info = jsys.process_frame(jsys.dataset.preprocess_frame(i))
        t_info = tsys.process_frame(tsys.dataset.preprocess_frame(i))
        if i > 0:
            assert j_info["reg_valid"] and t_info["reg_valid"], (i, j_info, t_info)
            assert t_info["photo_count"] > 0
        assert t_info["loss_finite"] and np.isfinite(t_info["loss_last"])
        Tj, Tt = jsys.cur_pose, tsys.cur_pose
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.02, (i, Tj[:3, 3], Tt[:3, 3])
        cos = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, i
        for a, b in ((int(tsys.state.count), int(jsys.state.count)),
                     (int(tsys.pool.fill), int(jsys.pool.fill))):
            assert abs(a - b) <= 0.05 * b, (i, a, b)
    # the colour head after the last frame: the colours both packages
    # regress at the map's points with a full neighbourhood agree
    from pin_slam_torch.models.decoder import blended_head, regress_color

    n = min(int(tsys.state.count), 2048)
    pts = tsys.state.positions[:n]
    knn = tn.knn_search(tsys.lm, tsys.mc, pts, tsys.offsets)
    _, col, w, _ = tn.interpolate_features(tsys.lm, tsys.mc, pts, knn.lidx, query_color=True)
    pred = np_(blended_head(regress_color, tsys.color_decoder, col, w, True))
    jk = jax.jit(jn.knn_search, static_argnums=1)(jsys.lm, jsys.mc, jnp.asarray(np_(pts)),
                                                  jsys.offsets)
    _, jc, jw, _ = jax.jit(jn.interpolate_features, static_argnums=(1,),
                           static_argnames=("query_color",))(
        jsys.lm, jsys.mc, jnp.asarray(np_(pts)), jk.lidx, query_color=True)
    jpred = np.asarray(jdec.blended_head(jdec.regress_color, jsys.color_params, jc, jw, True))
    full = np_(knn.nn_count) >= 6
    assert full.sum() > 100
    assert np.abs(pred[full] - jpred[full]).mean() < 1e-2


@pytest.mark.slow
def test_rgbd_color_pipeline_on_the_port(tmp_path):
    """tests/test_rgbd.py's gates on the port: 8 coloured frames through
    SlamSystem.run() with photometric tracking; the last position within
    0.2 m, the colours regressed at map points with a full neighbourhood
    within 0.2 (mean absolute error) of the painted field."""
    from test_rgbd import world_color

    from pin_slam_torch.models.decoder import blended_head, regress_color
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "rgbd_seq")
    make_rgbd_dataset(root, np.random.default_rng(42))
    cfg = TConfig()
    cfg.pc_path, cfg.pose_path = f"{root}/rgbd_ply", f"{root}/poses.txt"
    for k, v in COLOR.items():
        setattr(cfg, k, v)
    cfg.min_range, cfg.max_range = 0.2, 8.0
    cfg.min_z, cfg.max_z = -5.0, 5.0
    cfg.voxel_size_m = 0.1
    cfg.surface_sample_range_m = 0.05
    cfg.sigma_sigmoid_m = 0.02
    cfg.photometric_loss_on = True
    cfg.bs, cfg.iters = 4096, 12
    cfg.reg_iter_n = 50
    cfg.eigenvalue_check = False
    cfg.source_vox_down_m = 0.15
    cfg.silence = True
    cfg.map_capacity, cfg.local_map_capacity = 1 << 17, 1 << 16
    cfg.buffer_size, cfg.frame_bucket, cfg.source_bucket = 1 << 20, 1 << 14, 1 << 12
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 18, 1 << 18
    cfg._derive()
    cfg.output_root = str(tmp_path / "out")
    system = SlamSystem(cfg, device="cpu")
    system.run()
    est = np.stack(system.dataset.odom_poses)
    gt = system.dataset.gt_poses[: len(est)]
    errs = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert errs[-1] < 0.2, errs
    n = min(int(system.state.count), 2048)
    pts = system.state.positions[:n]
    knn = tn.knn_search(system.lm, system.mc, pts, system.offsets)
    _, col, w, _ = tn.interpolate_features(system.lm, system.mc, pts, knn.lidx,
                                           query_color=True)
    pred = np_(blended_head(regress_color, system.color_decoder, col, w,
                            system.mc.weighted_first))
    valid = np_(knn.nn_count) >= 6
    err = np.abs(pred[valid] - world_color(np_(pts)[valid])).mean()
    assert err < 0.2, f"color regression error {err:.3f}"
