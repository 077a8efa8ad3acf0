"""The port's loop detector (pin_slam_torch/slam/loop_detector.py) against the
JAX package's (jitted) on the same numpy inputs: scan-context descriptors,
ring keys, yaw-aligned distances, the on-device node descriptors, global
detection over a descriptor history, local detection and the ground-truth
oracle.

Bins are exact.  A point whose ring or sector coordinate lies within 1e-4 of
a bin edge (in bin units, float64) is left out of the inputs: there a 1-ulp
difference of sqrt/atan2/matmul between the two libraries may move it to the
neighbouring bin; 1e-4 of a bin is orders of magnitude above an ulp of the
coordinates here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pin_slam_torch.slam import loop_detector as tld
from pin_slam_tpu.slam import loop_detector as jld

R_, S_, MAXR = 20, 60, 80.0
EDGE = 1e-4


def make_scene(n=4000, seed_shape=0):
    rs = np.random.default_rng(seed_shape)
    pts = []
    for cx, cy, h in [(20, 5, 8), (-15, 12, 5), (5, -25, 12), (-20, -10, 3), (30, -18, 6)]:
        m = n // 5
        p = rs.uniform(-3, 3, size=(m, 3))
        p[:, 0] += cx
        p[:, 1] += cy
        p[:, 2] = rs.uniform(0, h, size=m) - 1.5
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def rotate_z(points, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return (points @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32).T
            ).astype(np.float32)


def off_edges(local64):
    """Mask of points whose (ring, sector) coordinates are >= EDGE from a bin edge."""
    x, y = local64[:, 0], local64[:, 1]
    ring = np.sqrt(x * x + y * y) / MAXR * R_
    sec = (np.arctan2(y, x) + np.pi) / (2 * np.pi) * S_
    far = lambda v: np.abs(v - np.round(v)) >= EDGE  # noqa: E731
    return far(ring) & far(sec)


def clean(points):
    return points[off_edges(points.astype(np.float64))]


def both_sc(points, valid=None):
    valid = np.ones(len(points), bool) if valid is None else valid
    j = np.asarray(jld.scan_context(jnp.asarray(points), jnp.asarray(valid)))
    t = tld.scan_context(torch.as_tensor(points), torch.as_tensor(valid)).numpy()
    return j, t


@pytest.mark.parametrize("seed", [0, 3])
def test_scan_context_and_ring_key_match_jax(seed):
    pts = clean(make_scene(seed_shape=seed))
    valid = np.random.default_rng(seed).random(len(pts)) < 0.9
    j, t = both_sc(pts, valid)
    np.testing.assert_array_equal(t, j)
    assert (t > 0).sum() > 20
    np.testing.assert_allclose(tld.ring_key(torch.as_tensor(t)).numpy(),
                               np.asarray(jld.ring_key(jnp.asarray(j))), rtol=1e-6, atol=1e-7)


def test_scan_context_feature_matches_jax():
    """Per-bin means: exact bins, sums in another order (rtol 1e-5)."""
    pts = clean(make_scene())
    feats = np.random.default_rng(1).normal(size=(len(pts), 8)).astype(np.float32)
    valid = np.ones(len(pts), bool)
    j = np.asarray(jld.scan_context_feature(jnp.asarray(pts), jnp.asarray(feats),
                                            jnp.asarray(valid)))
    t = tld.scan_context_feature(torch.as_tensor(pts), torch.as_tensor(feats),
                                 torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(t != 0, j != 0)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_yaw_distances_match_jax():
    """Same descriptors in: distances within 1e-5, yaw shifts exact."""
    base = clean(make_scene())
    d0 = both_sc(base)[0]
    cands = np.stack([both_sc(clean(rotate_z(make_scene(seed_shape=s), 2 * np.pi * k / 60)))[0]
                      for s, k in ((0, 13), (1, 5), (2, 40), (0, 0))])
    jd, js = jld.sc_distance_with_yaw(jnp.asarray(d0), jnp.asarray(cands))
    td, ts = tld.sc_distance_with_yaw(torch.tensor(d0), torch.tensor(cands))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(ts[0]) in (13, 47) and float(td[0]) < 0.1

    rng = np.random.default_rng(2)
    fq = rng.normal(size=(R_, S_, 8)).astype(np.float32)
    fc = np.stack([np.roll(fq, 7, axis=1), rng.normal(size=(R_, S_, 8)).astype(np.float32)])
    jd, js = jld.sc_feature_distance_with_yaw(jnp.asarray(fq), jnp.asarray(fc))
    td, ts = tld.sc_feature_distance_with_yaw(torch.as_tensor(fq), torch.as_tensor(fc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("with_feature", [False, True])
def test_node_descriptors_match_jax(with_feature):
    """build_node_descriptors (the pipeline's on-device path): a local map in
    the world frame, a frame pose with yaw, five lateral virtual nodes."""
    yaw, t_w = 0.3, np.array([4.0, -2.0, 0.5])
    c, s = np.cos(yaw), np.sin(yaw)
    R_w = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    local = make_scene().astype(np.float64)
    offsets = jld.NeuralPointMapContextManager(jld.LoopConfig()).lateral_offsets()
    keep = np.ones(len(local), bool)
    for off in offsets:
        keep &= off_edges(local + np.array([0.0, off, 0.0]))
    world = (local[keep] @ R_w.T + t_w).astype(np.float32)
    L1 = len(world) + 7                                # padded like the local map
    pos = np.full((L1, 3), 1e8, np.float32)
    pos[:len(world)] = world
    feats = np.random.default_rng(0).normal(size=(L1, 8)).astype(np.float32)
    args = (len(world), R_w.astype(np.float32), t_w.astype(np.float32))
    jo = jld.build_node_descriptors(jnp.asarray(pos), jnp.int32(args[0]), jnp.asarray(args[1]),
                                    jnp.asarray(args[2]), offsets, R_, S_, MAXR,
                                    features=jnp.asarray(feats), with_feature=with_feature)
    to = tld.build_node_descriptors(torch.as_tensor(pos), torch.tensor(args[0]),
                                    torch.as_tensor(args[1]), torch.as_tensor(args[2]),
                                    offsets, R_, S_, MAXR, features=torch.as_tensor(feats),
                                    with_feature=with_feature)
    assert len(jo) == len(to) == (4 if with_feature else 2)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _history(mod, with_feature):
    lc = mod.LoopConfig(min_travel_dist_ratio=0.02, local_map_radius=50.0,
                        cosdist_threshold=0.75 if with_feature else 0.25,
                        with_feature=with_feature)
    mgr = mod.NeuralPointMapContextManager(lc)
    rs = np.random.default_rng(5)
    travel = [0.0]
    scene_a = make_scene(seed_shape=0)
    feats_a = rs.normal(size=(len(scene_a), 8)).astype(np.float32)
    for fid, seed in enumerate([0, 1, 2, 3, 4]):
        pts = make_scene(seed_shape=seed)
        feats = feats_a if seed == 0 else rs.normal(size=(len(pts), 8)).astype(np.float32)
        _add_node(mod, mgr, fid, pts, feats if with_feature else None)
        travel.append(travel[-1] + 30.0)
    revisit = rotate_z(scene_a, np.pi / 6)
    _add_node(mod, mgr, 5, revisit, feats_a if with_feature else None)
    travel.append(travel[-1] + 30.0)
    return mgr, travel


def _add_node(mod, mgr, fid, pts, feats):
    """A sensor-frame cloud as a node: the JAX manager's host ``add_node``;
    the port's device path at the identity pose."""
    if mod is jld:
        mgr.add_node(fid, pts, np.ones(len(pts), bool), feats)
    else:
        mgr.add_node_device(fid, torch.tensor(pts), torch.tensor(len(pts)), torch.eye(3),
                            torch.zeros(3), None if feats is None else torch.tensor(feats))


@pytest.mark.parametrize("with_feature", [False, True])
def test_detect_global_loop_matches_jax(with_feature):
    jm, travel = _history(jld, with_feature)
    tm, _ = _history(tld, with_feature)
    jid, jdist, jyaw = jm.detect_global_loop(1.0, travel, cur_frame=5)
    tid, tdist, tyaw = tm.detect_global_loop(1.0, travel, cur_frame=5)
    assert (tid, tyaw) == (jid, jyaw) and tid == 0
    assert abs(tdist - jdist) < 1e-4
    # the drift-radius candidate mask (poses) rejects every far candidate
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, 0, 3] = np.arange(6) * 100.0
    assert tm.detect_global_loop(1.0, travel, 5, poses=poses)[0] == -1
    assert jm.detect_global_loop(1.0, travel, 5, poses=poses)[0] == -1


def test_pending_device_nodes_and_drop():
    mgr = tld.NeuralPointMapContextManager(tld.LoopConfig())
    pos = torch.as_tensor(make_scene())
    for fid in (1, 2, 3):
        mgr.add_node_device(fid, pos, torch.tensor(pos.shape[0]), torch.eye(3), torch.zeros(3))
    mgr.drop_pending(2)
    mgr.materialize_pending()
    assert mgr.frame_ids == [1, 3] and mgr.descriptors[0].shape == (5, R_, S_)


def test_detect_local_loop_matches_jax():
    n = 40
    poses = np.tile(np.eye(4), (n, 1, 1))
    xs = np.concatenate([np.linspace(0, 100, n // 2), np.linspace(100, 2, n // 2)])
    poses[:, 0, 3] = xs
    travel = [0.0]
    for i in range(1, n):
        travel.append(travel[-1] + abs(xs[i] - xs[i - 1]))
    for cur in (1, 10, 25, n - 1):
        for kw in ({}, {"accept_divisor": 2.2}, {"dist_floor": 6.0},
                   {"loop_candidate_mask": np.arange(n) % 2 == 0}):
            args = (poses, travel, cur, 5.0, 0.5, 50.0, 8.0)
            assert tld.detect_local_loop(*args, **kw) == jld.detect_local_loop(*args, **kw)
    assert tld.detect_local_loop(poses, travel, n - 1, 5.0, 0.5, 50.0, 8.0)[0] >= 0


def test_gt_loop_manager_matches_jax():
    jm, tm = jld.GTLoopManager(max_loop_dist=5.0), tld.GTLoopManager(max_loop_dist=5.0)
    pos, heading = np.zeros(3), np.array([1.0, 0.0, 0.0])
    fired = 0
    for i in range(161):
        T = np.eye(4)
        T[:3, 3] = pos
        jm.add_node(i, T)
        tm.add_node(i, T)
        (ji, jd, jt), (ti, td, tt) = jm.detect_loop(), tm.detect_loop()
        assert (ti, td) == (ji, jd)
        assert (jt is None and tt is None) or np.array_equal(tt, jt)
        fired += ti >= 0
        if i > 0 and i % 40 == 0:
            heading = np.array([-heading[1], heading[0], 0.0])
        pos = pos + heading
    assert fired > 0
