"""The port's semantic LiDAR profile against the JAX package's on the CPU:
the SemanticKITTI learning map and label files, labelled frames with and
without the moving-object filter, the sampler's classes, the pool's class
column through append and filter, the NLL loss, the semantic head after
the weight carry-across, the dynamic filter's keep mask, the autograd
training loop (the semantic head, a two-layer and a bias-free SDF decoder,
in both interpolation modes) against the JAX package's autodiff loop,
semantic vertex painting, the saved map with a semantic head, the
configuration's refusals, and the slice end to end on the labelled
corridor, frame by frame from synced state.

Integers and copied rows must match exactly.  Float tolerances are stated
at each test: the head rtol 1e-5 / atol 1e-6; the loss rtol 1e-6; the
training loop's parameters within 1e-4 of each leaf's largest magnitude
and its certainty sums within 1e-5 of theirs (Adam with eps 1e-15 turns
rounding-level gradient differences into step-size ones); the slice as
tests/test_torch_pipeline.py holds the main path."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import decoder as tdec
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.ops import losses as tlosses
from pin_slam_torch.slam import mapper as tm
from pin_slam_torch.utils import synthetic as syn
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.ops import losses as jlosses
from pin_slam_tpu.slam import mapper as jm

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEM = dict(semantic_on=True, filter_moving_object=True)


def _cfgs(**over):
    base = dict(SEM, map_capacity=1 << 14, local_map_capacity=1 << 12, buffer_size=1 << 18,
                downsample_hash_size=1 << 16, max_range=8.0)
    base.update(over)
    return small_config(JConfig, **base), small_config(TConfig, **base)


def _decoder_pair(seed, in_dim, H, level, out, bias=True):
    p = jdec.init_decoder(jax.random.PRNGKey(seed), in_dim, H, level, out, bias)
    return p, tdec.decoder_from_jax(p)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    """The labelled corridor (seed 3) in the SemanticKITTI layout, 8 frames
    of 2^13 points."""
    scans, labels, poses, world = syn.labelled_corridor_scans(3, 8, 1 << 13, n_az=900, n_el=96)
    root = str(tmp_path_factory.mktemp("sem"))
    seq = syn.write_semantic_kitti_sequence(root, "00", scans, labels, poses,
                                            correction_deg=0.195)
    return dict(seq=seq, scans=scans, labels=labels, poses=poses, world=world)


# ----------------------------------------------------------------------
# labels, frames, sampler, pool
# ----------------------------------------------------------------------


def test_learning_map_and_label_files_match(tmp_path):
    from pin_slam_torch.dataset import io as tio
    from pin_slam_torch.utils import semantic_kitti as tsk
    from pin_slam_tpu.dataset import io as jio
    from pin_slam_tpu.utils import semantic_kitti as jsk

    raw = np.concatenate([np.arange(0, 300), np.random.default_rng(0).integers(0, 260, 500)])
    np.testing.assert_array_equal(tsk.apply_learning_map(raw), jsk.apply_learning_map(raw))
    assert tsk.SEM_KITTI_LEARNING_MAP == jsk.SEM_KITTI_LEARNING_MAP
    assert tsk.SEM_KITTI_CLASS_NAMES == jsk.SEM_KITTI_CLASS_NAMES
    np.testing.assert_array_equal(tsk.SEM_KITTI_COLOR_MAP, jsk.SEM_KITTI_COLOR_MAP)
    lab = np.arange(-3, 25)
    np.testing.assert_array_equal(tsk.labels_to_colors(lab), jsk.labels_to_colors(lab))
    # instance ids in the upper 16 bits are dropped
    ids = (np.random.default_rng(1).integers(0, 1 << 16, 400).astype(np.uint32) << 16) \
        | np.random.default_rng(2).integers(0, 260, 400).astype(np.uint32)
    path = str(tmp_path / "000000.label")
    ids.tofile(path)
    t, j = tio.read_semantic_labels(path), jio.read_semantic_labels(path)
    assert t.dtype == np.int32 and t.max() < 260
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("moving", [True, False], ids=["filter_moving", "keep_moving"])
def test_read_and_preprocess_frame_labels_match(corridor, moving):
    """read_frame drops raw ids 0 and 1 and, under filter_moving_object, the
    moving classes (the person, raw 254); the learning classes follow their
    points through the crop, the random downsample and the bucket cap;
    points and labels equal the JAX package's."""
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset
    from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset

    seq = corridor["seq"]
    over = dict(pc_path=f"{seq}/velodyne", label_path=f"{seq}/labels", frame_bucket=1 << 12,
                filter_moving_object=moving, rand_downsample=True, rand_down_r=0.8,
                kitti_correction_on=True, correction_deg=0.195)
    jcfg, tcfg = _cfgs(**over)
    jd, td = JDataset(jcfg), TDataset(tcfg)
    for i in (0, 7):
        jp, _, js, _ = jd.read_frame(i)
        tp, _, _, ts_ = td.read_frame(i)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts_, js)
        assert (6 in set(ts_.tolist())) == (not moving)
        jf, tf = jd.preprocess_frame(i), td.preprocess_frame(i)
        for a, b in ((tf.points, jf.points), (tf.valid, jf.valid),
                     (tf.sem_labels, jf.sem_labels)):
            np.testing.assert_array_equal(a, b)
        assert tf.sem_labels.dtype == np.int32
        assert set(np.unique(tf.sem_labels[tf.valid]).tolist()) <= {1, 6, 9, 13, 18}
    tcfg.semantic_on = False
    assert TDataset(tcfg).preprocess_frame(0).sem_labels is None


def test_read_frame_drops_outliers_and_movers(tmp_path):
    """The JAX package's own case (tests/test_semantic.py): raw ids 0, 1,
    40, 50, 252 -> two points (9, 13) with the filter, three (9, 13, 1)
    without."""
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset

    root = tmp_path / "seq"
    (root / "velodyne").mkdir(parents=True)
    (root / "labels").mkdir()
    pts = np.array([[5, 0, 0, 0], [6, 0, 0, 0], [7, 0, 0, 0], [8, 0, 0, 0], [9, 0, 0, 0]],
                   np.float32)
    pts.tofile(root / "velodyne" / "000000.bin")
    np.array([0, 1, 40, 50, 252], np.uint32).tofile(root / "labels" / "000000.label")
    for moving, want in ((True, [9, 13]), (False, [9, 13, 1])):
        cfg = TConfig()
        cfg.pc_path, cfg.label_path = str(root / "velodyne"), str(root / "labels")
        cfg.semantic_on, cfg.filter_moving_object = True, moving
        points, _, _, sem = TDataset(cfg).read_frame(0)
        assert points.shape[0] == len(want)
        np.testing.assert_array_equal(sem, want)


def test_sample_rays_semantic_labels():
    from pin_slam_torch.ops.sampler import SamplerConfig as TSc, sample_rays as tsample
    from pin_slam_tpu.ops.sampler import SamplerConfig as JSc, sample_rays as jsample

    jcfg, tcfg = _cfgs()
    jsc, tsc = JSc.from_config(jcfg), TSc.from_config(tcfg)
    rng = np.random.default_rng(1)
    n = 300
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.2
    sem = rng.integers(0, 20, n).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jb = jsample(key, jsc, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(sem), None)
    k_surf, k_front, k_behind = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(d)) for d in (
        jax.random.normal(k_surf, (n, jsc.surface_sample_n)),
        jax.random.uniform(k_front, (n, jsc.free_front_n)),
        jax.random.uniform(k_behind, (n, jsc.free_behind_n))))
    tb = tsample(tsc, torch.as_tensor(pts), torch.as_tensor(valid), draws,
                 sem_label=torch.as_tensor(sem))
    np.testing.assert_array_equal(np_(tb.sem_label), np_(jb.sem_label))
    assert tb.sem_label.dtype == torch.int32
    S = tsc.ray_sample_count
    lab = np_(tb.sem_label).reshape(n, S)
    assert (lab[:, 0] == sem).all() and not lab[:, 1 + tsc.surface_sample_n:].any()


def test_pool_append_and_filter_move_semantic_labels():
    """Two frames appended (the second past the ring's end, so the head
    wraps) and a window filter: classes follow their rows; invalid rows
    get 0."""
    jcfg, tcfg = _cfgs(pool_capacity=1 << 10)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    jp, tp = jm.init_pool(jmcfg), tm.init_pool(tmcfg)
    assert tp.sem_label.shape == (1025,) and tp.sem_label.dtype == torch.int32
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
        sem = rng.integers(0, 20, n).astype(np.int32)
        jp = jm.pool_append(jp, jmcfg, jnp.asarray(coord), jnp.asarray(coord) - 1.0,
                            jnp.asarray(label), jnp.asarray(weight), jnp.asarray(valid),
                            jnp.int32(fid), jnp.asarray(new_mask), jnp.asarray(sem), None,
                            jnp.asarray(gidx), jnp.asarray(w), jnp.asarray(vec))
        tp = tm.pool_append(tp, tmcfg, torch.as_tensor(coord), torch.as_tensor(coord) - 1.0,
                            torch.as_tensor(label), torch.as_tensor(weight),
                            torch.as_tensor(valid), fid, torch.as_tensor(new_mask),
                            torch.as_tensor(gidx), torch.as_tensor(w), torch.as_tensor(vec),
                            sem_label=torch.as_tensor(sem))
        np.testing.assert_array_equal(np_(tp.sem_label), np_(jp.sem_label))
        np.testing.assert_array_equal(np_(tp.rows)[:, :15], np_(jp.rows)[:, :15])
        assert int(tp.head) == int(jp.head) and int(tp.fill) == int(jp.fill)
    origin = np.asarray([1.0, 0.5, 0.0], np.float32)
    jf = jm.pool_filter(jp, dataclasses.replace(jmcfg, window_radius=3.0), jnp.asarray(origin))
    tf = tm.pool_filter(tp, dataclasses.replace(tmcfg, window_radius=3.0),
                        torch.as_tensor(origin))
    assert 0 < int(tf.fill) == int(jf.fill) < int(jp.fill)
    np.testing.assert_array_equal(np_(tf.sem_label), np_(jf.sem_label))
    assert tm.pool_from_numpy(jf).sem_label.dtype == torch.int32


def test_sem_nll_loss_matches():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(500, 20)).astype(np.float32)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    label = rng.integers(0, 20, 500).astype(np.int32)
    valid = rng.random(500) > 0.3
    j = jlosses.sem_nll_loss(jnp.asarray(logp), jnp.asarray(label), valid=jnp.asarray(valid))
    t = tlosses.sem_nll_loss(torch.as_tensor(logp), torch.as_tensor(label),
                             valid=torch.as_tensor(valid))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    j0 = jlosses.sem_nll_loss(jnp.asarray(logp), jnp.asarray(label))
    t0 = tlosses.sem_nll_loss(torch.as_tensor(logp), torch.as_tensor(label))
    np.testing.assert_allclose(float(t0), float(j0), rtol=1e-6)


@pytest.mark.parametrize("level, bias", [(1, True), (2, True), (1, False)],
                         ids=["h1", "h2", "no_bias"])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_semantic_head_after_carry_across(level, bias, wf):
    """sem_label_prob / sem_label and blended_head of a JAX semantic head
    carried into the port's Decoder (one or two hidden layers, with or
    without biases): rtol 1e-5 / atol 1e-6; classes exact."""
    rng = np.random.default_rng(9)
    jp, tp = _decoder_pair(10, 11, 64, level, 20, bias)
    assert (tp.out.bias is not None) == bias and len(tp.hidden) == level
    feats = rng.normal(size=(300, 6, 11) if not wf else (300, 11)).astype(np.float32)
    w = rng.random((300, 6)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    jl = jdec.sem_label_prob(jp, jnp.asarray(feats))
    tl = tdec.sem_label_prob(tp, torch.as_tensor(feats))
    np.testing.assert_allclose(np_(tl), np_(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np_(tdec.sem_label(tp, torch.as_tensor(feats))),
                                  np_(jdec.sem_label(jp, jnp.asarray(feats))))
    jb = jdec.blended_head(jdec.sem_label_prob, jp, jnp.asarray(feats), jnp.asarray(w), wf)
    tb = tdec.blended_head(tdec.sem_label_prob, tp, torch.as_tensor(feats), torch.as_tensor(w), wf)
    np.testing.assert_allclose(np_(tb), np_(jb), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the autograd training loop
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def maps():
    """Both packages' maps after two inserts and their local maps."""
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
    return dict(jcfg=jcfg, tcfg=tcfg, jmc=jmc, tmc=tmc, js=js, ts=ts_, jlm=jlm, tlm=tlm,
                travel=travel)


def _loop_inputs(m, wf, sem_on, level, bias, seed=16):
    """A pool of sampled rays with cached kNN (JAX append_knn), random
    features, the SDF (and semantic) decoder pair, the batch key."""
    jcfg, tcfg = _cfgs(bs=256, bs_new_sample=32, iters=3, weighted_first=wf,
                       pool_capacity=1 << 12, semantic_on=sem_on, geo_mlp_level=level,
                       mlp_bias_on=bias)
    jmc = dataclasses.replace(m["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(m["tmc"], weighted_first=wf)
    jmcfg, tmcfg = jm.MapperConfig.from_config(jcfg), tm.MapperConfig.from_config(tcfg)
    jlm, tlm = m["jlm"], m["tlm"]
    rng = np.random.default_rng(seed)
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
    sem = np.where(np.arange(M) % S < near, rng.integers(0, 20, M), 0).astype(np.int32)
    jp = jm.pool_append(jm.init_pool(jmcfg), jmcfg, jnp.asarray(coords), jnp.asarray(coords),
                        jnp.asarray(label), jnp.asarray(weight), jnp.ones((M,), bool),
                        jnp.int32(1), jnp.asarray(rng.random(M) > 0.5),
                        jnp.asarray(sem) if sem_on else None, None, gidx, w, vec,
                        knn_nbr_vec=None if wf else rest[0])
    L, F = tmc.local_capacity, tmc.feature_dim
    feats = np.concatenate([0.05 * rng.standard_normal((L + 1, F)), np.zeros((L + 1, 1))],
                           1).astype(np.float32)
    jgeo, tgeo = _decoder_pair(18, F + 3, 64, level, 1, bias)
    jsem, tsem = _decoder_pair(19, F + 3, 64, 1, 20, bias) if sem_on else (None, None)
    return dict(jmc=jmc, tmc=tmc, jmcfg=jmcfg, tmcfg=tmcfg, jp=jp, feats=feats, jgeo=jgeo,
                tgeo=tgeo, jsem=jsem, tsem=tsem, key=jax.random.PRNGKey(20), tcfg=tcfg)


def _jax_layers(p):
    return [x for pair in list(p.hidden) + [p.out] for x in pair if x is not None]


@pytest.mark.parametrize("sem_on, decoder", [
    (True, "h1"), (True, "h2"), (True, "no_bias"), (False, "h2"), (False, "no_bias")],
    ids=["semantic-h1", "semantic-h2", "semantic-no_bias", "geometry-h2", "geometry-no_bias"])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_autograd_loop_matches(maps, wf, sem_on, decoder):
    """One call of mapping_loop_autograd (T = 3) from the same state and
    batch indices against the JAX package's mapping_loop_cached
    (use_kernel=False): every trained leaf (features, each SDF decoder
    leaf, each semantic decoder leaf) within 1e-4 of its largest
    magnitude, the certainty column within 1e-5 of its largest, the loss
    history rtol 1e-4.  The configurations are those the training kernels
    do not cover (kernel_path_supported False): a semantic head on the
    one-hidden-layer SDF decoder (path F's), a two-layer SDF decoder, and
    decoders without biases (the one-hidden-layer SDF decoder with biases
    and no semantic head trains on the kernels: tests/test_torch_mapper.py)."""
    level, bias = {"h1": (1, True), "h2": (2, True), "no_bias": (1, False)}[decoder]
    m = maps
    d = _loop_inputs(m, wf, sem_on, level, bias)
    assert not tm.kernel_path_supported(d["tmcfg"], d["tcfg"])
    jlm, tlm = m["jlm"], dataclasses.replace(m["tlm"])
    params = jm.TrainableParams(features=jnp.asarray(d["feats"]), color_features=None,
                                geo=d["jgeo"], sem=d["jsem"], color=None)
    lm_j, p_j, _, hist_j = jm.mapping_loop_cached(
        jlm, d["jmc"], params, jm.init_opt_state(d["jmcfg"], params), d["jp"], d["jmcfg"],
        d["key"], jnp.float32(0.7), jnp.ones((), bool), num_iters=3, use_kernel=False)
    idx = torch.as_tensor(np.array(jm._sample_batch_indices(
        d["key"], d["jp"], d["jmcfg"], jnp.ones((), bool), 3)), dtype=torch.int64)
    f0 = torch.as_tensor(d["feats"])
    heads = tm.init_heads(d["tgeo"], d["tsem"])
    lm_t, f_t, heads, _, hist_t = tm.mapping_loop_autograd(
        tlm, d["tmc"], f0, heads, tm.init_opt_state(f0, heads), tm.pool_from_numpy(d["jp"]),
        d["tmcfg"], idx, 0.7)
    np.testing.assert_allclose(np_(hist_t), np_(hist_j), rtol=1e-4)
    heads.load_into(d["tgeo"], d["tsem"])
    pairs = [(np_(f_t), np_(p_j.features))]
    for tdec_, jp_ in ((d["tgeo"], p_j.geo), (d["tsem"], p_j.sem)):
        if tdec_ is not None:
            tl = [x for pair in tdec_.layers() for x in pair if x is not None]
            pairs += list(zip([np_(x) for x in tl], [np_(x) for x in _jax_layers(jp_)]))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), err_msg=f"leaf {i}")
    cert_t, cert_j = np_(lm_t.attr_rows)[:, 7], np_(lm_j.attr_rows)[:, 7]
    np.testing.assert_allclose(cert_t, cert_j, atol=1e-5 * np.abs(cert_j).max())
    np.testing.assert_array_equal(np_(lm_t.attr_rows)[:, 9], np_(lm_j.attr_rows)[:, 9])
    assert np.abs(np_(f_t) - d["feats"]).max() > 1e-3              # the features trained
    if sem_on:
        assert np.abs(pairs[-1][0] - np_(_jax_layers(d["jsem"])[-1])).max() > 1e-4


def test_autograd_loop_graph_has_no_indexed_backward(maps, monkeypatch):
    """The autograd loop's graph reads the feature rows through the row
    kernels' Function (gather forward, in-order scatter backward) and holds
    no indexed gather / index_put / index_add backward, which add with float
    atomics on the card."""
    from test_torch_bundle_adjustment import _graph_names

    m = maps
    seen = []
    real = torch.autograd.grad

    def spy(outputs, inputs, *a, **kw):
        seen.append(_graph_names(outputs.grad_fn))
        return real(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    for wf in (True, False):
        d = _loop_inputs(m, wf, True, 1, True)
        idx = torch.as_tensor(np.array(jm._sample_batch_indices(
            d["key"], d["jp"], d["jmcfg"], jnp.ones((), bool), 2)), dtype=torch.int64)
        f0 = torch.as_tensor(d["feats"])
        heads = tm.init_heads(d["tgeo"], d["tsem"])
        tm.mapping_loop_autograd(m["tlm"], d["tmc"], f0, heads, tm.init_opt_state(f0, heads),
                                 tm.pool_from_numpy(d["jp"]), d["tmcfg"], idx, 1.0)
    assert len(seen) == 4
    for names in seen:
        assert "GatherRowsFnBackward" in names
        bad = {n for n in names if n.startswith(("Index", "Scatter", "Embedding", "Take", "Put"))
               or n.startswith("GatherBackward")}
        assert not bad, bad


# ----------------------------------------------------------------------
# vertex painting, the saved map
# ----------------------------------------------------------------------


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_paint_semantics_matches(maps, wf):
    """The port's Mesher.paint_semantics against the JAX Mesher's
    _paint_vertices (query buckets of 64, the last one padded): classes
    exact; recon_aabb_mesh returns them with the mesh."""
    from pin_slam_torch.slam.mesher import Mesher as TMesher, MesherConfig as TMc
    from pin_slam_tpu.slam.mesher import Mesher as JMesher, MesherConfig as JMc

    m = maps
    L, F = m["tmc"].local_capacity, m["tmc"].feature_dim
    feats = np.random.default_rng(11).normal(size=(L + 1, F)).astype(np.float32)
    jlm = m["jlm"]._replace(geo_features=jnp.asarray(feats))
    tlm = dataclasses.replace(m["tlm"], geo_features=torch.as_tensor(feats))
    jmc = dataclasses.replace(m["jmc"], weighted_first=wf)
    tmc = dataclasses.replace(m["tmc"], weighted_first=wf)
    cfg = m["jcfg"]
    offs = jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
    pos = np_(tlm.positions)[: int(tlm.count)]
    verts = (pos[:300] + np.random.default_rng(12).normal(0, 0.1, (300, 3))).astype(np.float32)
    jsem, tsem = _decoder_pair(13, 11, 64, 1, 20)
    geo = jdec.init_decoder(jax.random.PRNGKey(14), 11, 64, 1, 1)
    _, js = JMesher(JMc(query_bucket=64, semantic_on=True), jmc,
                    jnp.asarray(offs))._paint_vertices(jlm, geo, None, jsem, 1.0, verts)
    tmesh = TMesher(TMc(query_bucket=64, semantic_on=True), tmc, torch.as_tensor(offs))
    ts_ = tmesh.paint_semantics(tlm, tsem, verts)
    assert ts_.shape == (300,) and ts_.dtype == np.int32
    np.testing.assert_array_equal(ts_, js)
    assert len(np.unique(ts_)) > 1
    lo, hi = pos[0] - 1.0, pos[0] + 1.0
    loose = TMesher(TMc(query_bucket=1 << 12, mesh_min_nn=1, min_cluster_vertices=0), tmc,
                    torch.as_tensor(offs))
    v, f, c, s = loose.recon_aabb_mesh(tlm, tdec.decoder_from_jax(geo), 1.0, lo, hi,
                                       sem_decoder=tsem)
    assert c is None and len(v) > 0
    np.testing.assert_array_equal(s, tmesh.paint_semantics(tlm, tsem, v))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_map_with_semantic_head_loads_in_the_other_package(maps, writer, tmp_path):
    from pin_slam_torch.utils import experiment as texp
    from pin_slam_tpu.utils import experiment as jexp

    m = maps
    js, ts_ = m["js"], m["ts"]
    geo = jdec.init_decoder(jax.random.PRNGKey(15), 11, 64, 1, 1)
    jsem, tsem = _decoder_pair(16, 11, 64, 2, 20, False)
    path = str(tmp_path / "pin_map.npz")
    if writer == "jax":
        jexp.save_implicit_map(path, js, geo, jsem, None)
    else:
        texp.save_implicit_map(path, ts_, tdec.decoder_from_jax(geo), sem_decoder=tsem)
    blob = dict(np.load(path))
    assert "decoder_sem_out_W" in blob and "decoder_sem_out_b" not in blob
    _, _, jsem2, jcol2 = jexp.load_implicit_map(path, m["jmc"])
    tst, tgeo, tsem2 = texp.load_implicit_map(path, m["tmc"], device="cpu", semantic=True)
    assert jcol2 is None and int(tst.count) == int(js.count)
    for a, b, c in zip([x for pair in tsem2.layers() for x in pair if x is not None],
                       _jax_layers(jsem2), _jax_layers(jsem)):
        np.testing.assert_array_equal(np_(a), np_(b))
        np.testing.assert_array_equal(np_(a), np_(c))
    assert texp.load_implicit_map(path, m["tmc"], device="cpu", color=True)[2] is None
    assert len(texp.load_implicit_map(path, m["tmc"], device="cpu")) == 2


# ----------------------------------------------------------------------
# the pipeline: configuration, the dynamic filter, the slice
# ----------------------------------------------------------------------


def _system_config(Config, seq, **over):
    """run_kitti.yaml with path F's options on the labelled corridor, at
    test capacities."""
    cfg = Config().load(os.path.join(ROOT, "config", "lidar_slam", "run_kitti.yaml"))
    cfg.pc_path, cfg.label_path = f"{seq}/velodyne", f"{seq}/labels"
    cfg.pose_path, cfg.calib_path = f"{seq}/poses.txt", f"{seq}/calib.txt"
    for k, v in dict(semantic_on=True, filter_moving_object=True, dynamic_filter_on=True,
                     estimate_normal=True).items():
        setattr(cfg, k, v)
    cfg.pgo_on, cfg.silence = False, True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 17, 1 << 17
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, 1 << 13, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg._derive()
    return cfg


def test_semantic_profile_options_are_ported(corridor, monkeypatch):
    """check_ported takes the semantic profile's options (semantic_on,
    filter_moving_object, dynamic_filter_on, estimate_normal) and the SDF
    decoders outside the kernels (geo_mlp_level 2, mlp_bias_on False),
    which train by autograd, positional encoding, query_nn_k != 6 and the
    colour head beside the semantic head (the autograd loop trains it); on
    the cached training path it still refuses layer-norm (ROADMAP C 14),
    which PIN_SLAM_EXACT_KNN=1 (the uncached loop) trains."""
    from pin_slam_torch.slam.pipeline import SlamSystem

    seq = corridor["seq"]
    s = SlamSystem(_system_config(TConfig, seq), device="cpu")
    assert not s.kernel_path and s.sem_decoder is not None
    assert s.sem_decoder.out.out_features == 20 and s.pool.sem_label is not None
    for over in (dict(semantic_on=False, geo_mlp_level=2), dict(semantic_on=False,
                                                               mlp_bias_on=False)):
        s2 = SlamSystem(_system_config(TConfig, seq, **over), device="cpu")
        assert not s2.kernel_path and s2.sem_decoder is None
    assert SlamSystem(_system_config(TConfig, seq, semantic_on=False), device="cpu").kernel_path
    with pytest.raises(NotImplementedError, match="ROADMAP C 14"):
        SlamSystem(_system_config(TConfig, seq, layer_norm_on=True), device="cpu")
    s_col = SlamSystem(_system_config(TConfig, seq, color_on=True), device="cpu")
    assert not s_col.kernel_path and s_col.color_decoder is not None
    assert s_col.sem_decoder is not None and s_col.pool.color_label is not None
    s_pe = SlamSystem(_system_config(TConfig, seq, pos_encoding_band=4), device="cpu")
    assert s_pe.sem_decoder.hidden[0].in_features == 8 + 27
    s_k8 = SlamSystem(_system_config(TConfig, seq, query_nn_k=8), device="cpu")
    assert s_k8.mcfg.nn_k == 8 and s_k8.pool.rows.shape[1] == s_k8.mcfg.pool_dim
    monkeypatch.setenv("PIN_SLAM_EXACT_KNN", "1")
    s_ex = SlamSystem(_system_config(TConfig, seq, layer_norm_on=True, color_on=True),
                      device="cpu")
    assert s_ex.exact_knn and not s_ex.kernel_path and s_ex.color_decoder is not None
    monkeypatch.setenv("PIN_SLAM_EXACT_KNN", "0")
    assert not SlamSystem(_system_config(TConfig, seq), device="cpu").exact_knn


def test_semantic_decoder_comes_from_the_seed(corridor):
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _system_config(TConfig, corridor["seq"])
    s = SlamSystem(cfg, device="cpu")
    gen = torch.Generator().manual_seed(int(cfg.seed))
    Decoder(cfg.feature_dim + 3, cfg.geo_mlp_hidden_dim, cfg.geo_mlp_level, 1, True,
            generator=gen)
    sem = Decoder(cfg.feature_dim + 3, cfg.sem_mlp_hidden_dim, cfg.sem_mlp_level,
                  cfg.sem_class_count, True, generator=gen)
    for a, b in zip(sem.parameters(), s.sem_decoder.parameters()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def mapped(corridor):
    """The port's SlamSystem (path F's options) after frames 0-6 of the
    labelled corridor; the car entered at frame 6."""
    from pin_slam_torch.slam.pipeline import SlamSystem

    s = SlamSystem(_system_config(TConfig, corridor["seq"]), device="cpu")
    for i in range(7):
        info = s.process_frame(s.dataset.preprocess_frame(i))
        assert i == 0 or info["reg_valid"]
    return s


@pytest.mark.parametrize("thre", [(4.0, 1.5), (2.0, 0.75)], ids=["defaults", "moved"])
def test_dynamic_filter_keep_mask_matches(corridor, mapped, thre):
    """The dynamic filter's keep mask at frame 7's points and pose from the
    same local map and decoder, against the JAX package's filter
    (pipeline.py frame_update: knn_search, interpolate_features,
    blended_sdf against the two thresholds) run jitted on the same state:
    exact, with the thresholds at their defaults and both moved away."""
    s = mapped
    cfg = s.config
    cert_thre, ratio = thre
    old = (cfg.dynamic_certainty_thre, cfg.dynamic_sdf_ratio_thre)
    cfg.dynamic_certainty_thre, cfg.dynamic_sdf_ratio_thre = thre
    try:
        f = s.dataset.preprocess_frame(7)
        T = corridor["poses"][7]
        R = torch.as_tensor(T[:3, :3], dtype=torch.float32)
        t = torch.as_tensor(T[:3, 3], dtype=torch.float32)
        keep_t = np_(s.dynamic_static_mask(torch.as_tensor(f.points), R, t))
    finally:
        cfg.dynamic_certainty_thre, cfg.dynamic_sdf_ratio_thre = old
    lm = s.lm
    jmc = jn.MapConfig.from_config(cfg)
    jlm = jn.LocalMap(indices=jnp.asarray(np_(lm.indices).astype(np.int32)),
                      attr_rows=jnp.asarray(np_(lm.attr_rows)),
                      geo_features=jnp.asarray(np_(lm.geo_features)), color_features=None,
                      count=jnp.int32(int(lm.count)), member_mask=jnp.asarray(np_(lm.member_mask)),
                      lo1=jnp.int32(int(lm.lo1)), lo2=jnp.int32(int(lm.lo2)),
                      origin=jnp.asarray(np_(lm.origin)), hash_rows=jnp.asarray(np_(lm.hash_rows)))
    layers = [(jnp.asarray(np_(W).copy()), jnp.asarray(np_(b).copy()))
              for W, b in s.decoder.layers()]
    jgeo = jdec.DecoderParams(hidden=tuple(layers[:-1]), out=layers[-1])
    offsets = jnp.asarray(jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha))

    @jax.jit
    def jax_filter(lm_, geo_p, points, pose_R, pose_t):
        pts_world = points @ pose_R.T + pose_t
        knn = jn.knn_search(lm_, jmc, pts_world, offsets)
        feat, _, w, cert = jn.interpolate_features(lm_, jmc, pts_world, knn.lidx)
        sdf_pred, _ = jdec.blended_sdf(geo_p, feat, w, jmc.weighted_first, cfg.sdf_scale)
        return (cert < cert_thre) | (sdf_pred < ratio * cfg.voxel_size_m)

    keep_j = np_(jax_filter(jlm, jgeo, jnp.asarray(f.points), jnp.asarray(np_(R)),
                            jnp.asarray(np_(t))))
    np.testing.assert_array_equal(keep_t, keep_j)
    valid = f.valid
    car = valid & (f.sem_labels == 1)
    static = valid & np.isin(f.sem_labels, (9, 13, 18))
    assert car.sum() > 20
    assert (~keep_t[car]).mean() > 0.05                         # it drops part of the car
    assert keep_t[static].mean() > 0.99                          # and keeps the surfaces


def _sync_semantic(tsys, jsys):
    from test_torch_pipeline import _sync_from_jax

    from pin_slam_torch.models.decoder import params_from_jax

    _sync_from_jax(tsys, jsys)
    tsys.sem_decoder.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jsys.sem_params)))
    assert tsys.pool.sem_label is not None


def test_semantic_slice_matches_jax(corridor):
    """The slice end to end: the port's SlamSystem against the JAX
    package's on the labelled corridor with path F's options (run_kitti.yaml
    with semantic_on, filter_moving_object, dynamic_filter_on and
    estimate_normal), each frame from the JAX system's state (map, local
    map, pool and its classes, both decoders, pose books) with the JAX
    package's random draws, held as tests/test_torch_pipeline.py holds the
    main path: every frame registers in both, poses within 2 cm / 0.2 deg,
    map and pool sizes within 5 %, finite losses; the pool's classes are
    the scene's learning classes (never the person's), and equal where the
    two pools' rows are the same samples; after the last frame the
    semantic heads' classes at the map's points with a full neighbourhood
    agree at 98 %."""
    from test_torch_pipeline import JaxDraws

    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    seq = corridor["seq"]
    jsys = JSlam(_system_config(JConfig, seq))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    tcfg = _system_config(TConfig, seq)
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    tsys.tc = dataclasses.replace(tsys.tc, min_valid_ratio=0.1)
    assert jsys.sem_params is not None and not tsys.kernel_path
    for i in range(8):
        _sync_semantic(tsys, jsys)
        j_info = jsys.process_frame(jsys.dataset.preprocess_frame(i))
        t_info = tsys.process_frame(tsys.dataset.preprocess_frame(i))
        if i > 0:
            assert j_info["reg_valid"] and t_info["reg_valid"], (i, j_info, t_info)
        assert t_info["loss_finite"] and np.isfinite(t_info["loss_last"])
        Tj, Tt = jsys.cur_pose, tsys.cur_pose
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.02, (i, Tj[:3, 3], Tt[:3, 3])
        cos = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, i
        for a, b in ((int(tsys.state.count), int(jsys.state.count)),
                     (int(tsys.pool.fill), int(jsys.pool.fill))):
            assert abs(a - b) <= 0.05 * b, (i, a, b)
        ts_, js_ = np_(tsys.pool.sem_label), np_(jsys.pool.sem_label)
        assert set(np.unique(ts_).tolist()) <= {0, 1, 9, 13, 18}
        same = np.all(np_(tsys.pool.rows)[:, :3] == np_(jsys.pool.rows)[:, :3], axis=1)
        np.testing.assert_array_equal(ts_[same], js_[same])
    from pin_slam_torch.models.decoder import blended_head, sem_label_prob

    n = min(int(tsys.state.count), 4096)
    pts = tsys.state.positions[:n]
    knn = tn.knn_search(tsys.lm, tsys.mc, pts, tsys.offsets)
    feat, w, _ = tn.interpolate_features(tsys.lm, tsys.mc, pts, knn.lidx)
    pred = np_(torch.argmax(blended_head(sem_label_prob, tsys.sem_decoder, feat, w,
                                         tsys.mc.weighted_first), -1))
    jk = jax.jit(jn.knn_search, static_argnums=1)(jsys.lm, jsys.mc, jnp.asarray(np_(pts)),
                                                  jsys.offsets)
    jf, _, jw, _ = jax.jit(jn.interpolate_features, static_argnums=(1,))(
        jsys.lm, jsys.mc, jnp.asarray(np_(pts)), jk.lidx)
    jpred = np.asarray(jnp.argmax(jdec.blended_head(jdec.sem_label_prob, jsys.sem_params, jf,
                                                    jw, jsys.mc.weighted_first), -1))
    full = np_(knn.nn_count) >= 6
    assert full.sum() > 100
    assert (pred[full] == jpred[full]).mean() > 0.98
