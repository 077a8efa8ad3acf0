"""The port's map deformation after a pose-graph optimisation against the
JAX package's, on a map and pool the port built from three frames of the
synthetic corridor scene (CPU): ``adjust_map`` (allclose), ``recreate_hash``
(hash table exact), ``build_local_map`` with a travel window (exact),
``pool_retransform`` and ``pool_refresh_cache`` (allclose), and the
``after_pgo`` branches with non-identity quaternions: ``interpolate_features``
and the tracker's ``sdf_value_and_grad_cached``.

Tolerances: positions and pool coordinates are 3x3 matrix-vector products
of ~20 m coordinates (summation order may differ: atol 2e-5 m); quaternions,
IDW weights and offset vectors rtol 1e-5 / atol 1e-6; SDF values and
gradients rtol 1e-4 / atol 1e-5 as in test_torch_tracker.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

torch.set_num_threads(1)
N_RAYS = 1 << 13


def _rot(axis_angle):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(axis_angle).as_matrix()


@pytest.fixture(scope="module")
def built():
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    cfg = Config()
    cfg.pgo_on, cfg.silence = False, True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 17, 1 << 16
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, N_RAYS, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    cfg.weighted_first = False
    cfg._derive()
    s = SlamSystem(cfg, device="cpu")
    s.tc = dataclasses.replace(s.tc, min_valid_ratio=0.1)
    rng = np.random.default_rng(0)
    world = syn.make_world(np.random.default_rng(0))
    for i in range(3):
        R, t = syn.sensor_pose(i)
        arr, valid = pad_to(syn.lidar_scan(rng, world, t, R, N_RAYS), N_RAYS)
        info = s.process_frame(Frame(arr, valid, int(valid.sum())))
        assert i == 0 or info["reg_valid"], (i, info)
    # per-frame pose corrections: small rotations about tilted axes plus shifts
    g = np.random.default_rng(1)
    diff = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    for f in range(3):
        diff[f, :3, :3] = _rot(g.normal(size=3) * 0.05)
        diff[f, :3, 3] = g.normal(size=3) * 0.2
    return dict(s=s, cfg=cfg, diff=diff)


def _jax_state(ts):
    from pin_slam_tpu.models import neural_points as jn

    return jn.MapState(attr_rows=jnp.asarray(np_(ts.attr_rows)),
                       geo_features=jnp.asarray(np_(ts.geo_features)), color_features=None,
                       count=jnp.int32(int(ts.count)),
                       hash_table=jnp.asarray(np_(ts.hash_table).astype(np.int32)))


def _jax_mc(cfg):
    from pin_slam_tpu.models import neural_points as jn

    return jn.MapConfig.from_config(cfg)


def _copy_state(st):
    return dataclasses.replace(st, attr_rows=st.attr_rows.clone(),
                               geo_features=st.geo_features.clone(),
                               hash_table=st.hash_table.clone())


@pytest.fixture(scope="module")
def deformed(built):
    """The map deformed by both packages from the same state."""
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_tpu.models import neural_points as jn

    s = built["s"]
    jmc = _jax_mc(built["cfg"])
    js = jn.adjust_map(_jax_state(s.state), jmc, jnp.asarray(built["diff"]))
    ts = tn.adjust_map(_copy_state(s.state), s.mc, torch.as_tensor(built["diff"]))
    return dict(js=js, ts=ts, jmc=jmc)


def test_adjust_map_matches_jax(built, deformed):
    from pin_slam_torch.models import neural_points as tn

    js, ts = deformed["js"], deformed["ts"]
    ja, ta = np_(js.attr_rows), np_(ts.attr_rows)
    n = int(ts.count)
    assert n > 1000
    np.testing.assert_allclose(ta[:, tn.C_POS], ja[:, tn.C_POS], rtol=0, atol=2e-5)
    np.testing.assert_allclose(ta[:, tn.C_QUAT], ja[:, tn.C_QUAT], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ta[:, 7:], ja[:, 7:])
    # the points really moved and turned; the sentinel row is restored
    before = np_(built["s"].state.attr_rows)
    assert np.abs(ta[:n, :3] - before[:n, :3]).max() > 0.1
    assert np.abs(ta[:n, 4:7]).max() > 1e-2
    np.testing.assert_array_equal(ta[-1], np_(tn.attr_sentinel_row()))


@pytest.mark.parametrize("cur_ts", [2, 0])
def test_recreate_hash_matches_jax(built, deformed, cur_ts):
    """Same deformed rows in (the JAX package's), the same hash table out."""
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_tpu.models import neural_points as jn

    js = deformed["js"]
    cfg = built["cfg"]
    jh = jn.recreate_hash(js, deformed["jmc"], jnp.int32(cur_ts),
                          downsample_table_size=cfg.downsample_hash_size)
    th = tn.recreate_hash(tn.state_from_numpy(js), built["s"].mc, cur_ts,
                          downsample_table_size=cfg.downsample_hash_size)
    np.testing.assert_array_equal(np_(th.hash_table), np_(jh.hash_table))
    assert (np_(th.hash_table) < built["s"].mc.capacity).sum() > 1000


def test_build_local_map_travel_window_matches_jax(built, deformed):
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_tpu.models import neural_points as jn

    s = built["s"]
    js = deformed["js"]
    travel = np_(s._travel[:64]).copy()                # the run's: 0, 0.1, 0.3 m
    origin = np.asarray([1.0, 0.2, 0.0], np.float32)
    counts = []
    for tw in (0.25, 100.0):
        jlm = jn.build_local_map(js, deformed["jmc"], jnp.asarray(origin), jnp.int32(2),
                                 jnp.asarray(travel), travel_window=jnp.float32(tw))
        tlm = tn.build_local_map(tn.state_from_numpy(js), s.mc, torch.as_tensor(origin), 2,
                                 torch.as_tensor(travel), travel_window=tw)
        assert int(tlm.count) == int(jlm.count) > 0
        counts.append(int(tlm.count))
        for f in ("indices", "member_mask", "hash_rows", "attr_rows"):
            np.testing.assert_array_equal(np_(getattr(tlm, f)), np_(getattr(jlm, f)), err_msg=f)
    assert counts[0] < counts[1], (counts, travel[:3])   # the window left frame 0 out


def _jax_pool(tp):
    from pin_slam_tpu.slam import mapper as jmp

    return jmp.PoolState(rows=jnp.asarray(np_(tp.rows)), sem_label=None, color_label=None,
                         head=jnp.int32(int(tp.head)), fill=jnp.int32(int(tp.fill)),
                         new_idx=jnp.asarray(np_(tp.new_idx).astype(np.int32)),
                         new_count=jnp.int32(int(tp.new_count)))


def test_pool_retransform_and_refresh_match_jax(built, deformed, monkeypatch):
    from pin_slam_torch.slam import mapper as tm
    from pin_slam_tpu.slam import mapper as jmp

    s = built["s"]
    poses = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    for f in range(3):
        poses[f] = built["diff"][f] @ np.asarray(s.dataset.odom_poses[f], np.float32)
    jp = jmp.pool_retransform(_jax_pool(s.pool), jnp.asarray(poses))
    tp = tm.pool_retransform(tm.pool_from_numpy(s.pool), torch.as_tensor(poses))
    np.testing.assert_allclose(np_(tp.rows), np_(jp.rows), rtol=0, atol=2e-5)

    # refresh against the deformed map (non-identity quaternions), from the
    # retransformed and from the original pool; small chunks to exercise the
    # chunk loop
    js = deformed["js"]
    monkeypatch.setattr(tm, "REFRESH_CHUNK", 5000)
    fill = int(s.pool.fill)
    for pool_j in (jp, _jax_pool(s.pool)):
        jr = jmp.pool_refresh_cache(pool_j, js.attr_rows, deformed["jmc"])
        tr = tm.pool_refresh_cache(tm.pool_from_numpy(pool_j),
                                   torch.as_tensor(np_(js.attr_rows).copy()), s.mc)
        a, b = np_(tr.rows), np_(jr.rows)
        assert a.shape[1] == tm.P_VEC0 + 3 + 18         # per-neighbour vectors cached
        np.testing.assert_array_equal(a[:, :tm.P_W.start], b[:, :tm.P_W.start])
        np.testing.assert_allclose(a[:, tm.P_W.start:], b[:, tm.P_W.start:],
                                   rtol=1e-5, atol=1e-6)
        change = np.abs(a[:fill, tm.P_VEC0:] - np_(s.pool.rows)[:fill, tm.P_VEC0:]).max()
        assert change > 1e-2


def _rotated_lms(built):
    """The port's local map and the JAX copy with random unit quaternions."""
    from pin_slam_tpu.models import neural_points as jn

    s = built["s"]
    lm = s.lm
    q = np.random.default_rng(5).normal(size=(lm.attr_rows.shape[0], 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    attr = np_(lm.attr_rows).copy()
    attr[:, 3:7] = q
    tlm = dataclasses.replace(lm, attr_rows=torch.as_tensor(attr))
    jlm = jn.LocalMap(indices=jnp.asarray(np_(lm.indices).astype(np.int32)),
                      attr_rows=jnp.asarray(attr),
                      geo_features=jnp.asarray(np_(lm.geo_features)), color_features=None,
                      count=jnp.int32(int(lm.count)),
                      member_mask=jnp.asarray(np_(lm.member_mask)),
                      lo1=jnp.int32(int(lm.lo1)), lo2=jnp.int32(int(lm.lo2)),
                      origin=jnp.asarray(np_(lm.origin)), hash_rows=jnp.asarray(np_(lm.hash_rows)))
    return tlm, jlm


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_interpolate_features_after_pgo_matches_jax(built, wf):
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_tpu.models import neural_points as jn

    s, cfg = built["s"], built["cfg"]
    tlm, jlm = _rotated_lms(built)
    tmc = dataclasses.replace(s.mc, weighted_first=wf)
    jmc = dataclasses.replace(_jax_mc(cfg), weighted_first=wf)
    q = np.random.default_rng(6).uniform(-8, 8, size=(600, 3)).astype(np.float32)
    q[:, 2] *= 0.2
    offs = jn.neighbor_offsets(cfg.num_nei_cells, cfg.search_alpha)
    jk = jax.jit(jn.knn_search, static_argnums=1)(jlm, jmc, jnp.asarray(q), jnp.asarray(offs))
    tk = tn.knn_search(tlm, tmc, torch.as_tensor(q), torch.as_tensor(offs))
    np.testing.assert_array_equal(np_(tk.lidx), np_(jk.lidx))
    assert (np_(tk.lidx) < tmc.local_capacity).mean() > 0.2
    jg, _, jw, jc = jax.jit(jn.interpolate_features, static_argnums=(1, 4))(
        jlm, jmc, jnp.asarray(q), jk.lidx, True)
    tg, tw, tc = tn.interpolate_features(tlm, tmc, torch.as_tensor(q), tk.lidx, after_pgo=True)
    for a, b in ((tg, jg), (tw, jw), (tc, jc)):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-6)
    # the rotation changed the offset vectors
    t0, _, _ = tn.interpolate_features(tlm, tmc, torch.as_tensor(q), tk.lidx)
    assert np.abs(np_(t0) - np_(tg)).max() > 1e-2


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_tracker_sdf_and_grad_after_pgo_match_jax(built, wf):
    from pin_slam_torch.slam import tracker_grad as ttg
    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import tracker_grad as jtg

    s, cfg = built["s"], built["cfg"]
    tlm, jlm = _rotated_lms(built)
    tmc = dataclasses.replace(s.mc, weighted_first=wf)
    jmc = dataclasses.replace(_jax_mc(cfg), weighted_first=wf)
    (W1, b1), (W2, b2) = ((np_(W).copy(), np_(b).copy()) for W, b in s.decoder.layers())
    jgeo = jdec.DecoderParams(hidden=((jnp.asarray(W1), jnp.asarray(b1)),),
                              out=(jnp.asarray(W2), jnp.asarray(b2)))
    pts = torch.as_tensor(np_(tlm.attr_rows)[:int(tlm.count):7, :3]
                          + np.float32([0.05, -0.03, 0.02]))
    jt = jn.make_probe_template(jmc, cfg.num_nei_cells, cfg.search_alpha)
    jc = jax.jit(jtg.probe_candidates, static_argnums=1)(jlm, jmc, jnp.asarray(np_(pts)), jt)
    tc = ttg.probe_candidates(tlm, tmc, pts, s.append_tmpl)
    q = pts + 0.02
    jr = jax.jit(jtg.sdf_value_and_grad_cached, static_argnums=(2, 4))(
        jc, jlm, jmc, jgeo, s.sdf_scale, jnp.asarray(np_(q)), True)
    tr = ttg.sdf_value_and_grad_cached(tc, tlm, tmc, s.decoder, s.sdf_scale, q, after_pgo=True)
    np.testing.assert_array_equal(np_(tr[2]), np_(jr[2]))
    for a, b in ((tr[0], jr[0]), (tr[1], jr[1]), (tr[3], jr[3])):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-5)
    # the analytic gradient is the gradient of the rotated-offset SDF
    q64 = q.double()
    eps = 1e-3
    num = []
    for d in range(3):
        dq = torch.zeros(3, dtype=torch.float64)
        dq[d] = eps
        hi = ttg.sdf_value_and_grad_cached(tc, tlm, tmc, s.decoder, s.sdf_scale,
                                           (q64 + dq).float(), after_pgo=True)[0]
        lo = ttg.sdf_value_and_grad_cached(tc, tlm, tmc, s.decoder, s.sdf_scale,
                                           (q64 - dq).float(), after_pgo=True)[0]
        num.append((hi.double() - lo.double()) / (2 * eps))
    num = torch.stack(num, -1)
    ok = np_(tr[2]) >= 6
    err = (num - tr[1].double()).norm(dim=-1)[torch.as_tensor(ok)]
    assert float(err.median()) < 0.05 * float(tr[1].norm(dim=-1).median())
