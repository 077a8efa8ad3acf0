"""The port's SlamSystem with PGO on (pin_slam_torch.slam.pipeline) against
the JAX package's on the synthetic corridor scene, frame by frame from synced
state (see test_torch_pipeline.py for why a free-running comparison is
meaningless on this scene):

* one loop closure forced identically in both systems (the local detector is
  monkeypatched to name the same loop frame at the same detection frame, as
  tests/test_full_slam.py does for the global path): both verify it by
  registration, optimise the pose graph and deform the map; the PGO poses,
  the map positions and quaternions, the hash table and the pool rows are
  compared after that frame;
* the frames after it, with ``after_pgo`` (non-identity quaternions) in the
  tracker, the append-time kNN cache and the eikonal stencil;
* and, slow-marked, the JAX package's square-loop gate on the port.

Tolerances: the verification registration agrees to ~1e-4 m between the
packages (float32 Gauss-Newton), so the optimised poses are compared to
2e-3 m / 2e-3 rad, map positions and pool coordinates to 2e-3 m; the hash
table is rebuilt from those positions and so may differ at slots of points
within ~1e-3 m of a voxel face: at least 99.5 % of its occupied slots must
agree.  Per-frame poses after the closure: within 2 cm / 0.2 deg, map and
pool sizes within 5 % (as test_torch_pipeline.py)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU platform set by conftest)

from test_torch_pipeline import N_RAYS, JaxDraws, _config, _sync_from_jax
from torch_port_util import np_

torch.set_num_threads(1)
# the sensor drives 1 m down the corridor and back, so frame 8 revisits the
# pose of frame 2 (the forced loop); detection runs on every other frame
U = [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0]
CLOSE_AT, LOOP_TO, PGO_FREQ = 8, 2, 2


def _revisit_frames():
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(np.random.default_rng(0))
    out = []
    for u in U:
        yaw = 0.004 * u
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        t = np.array([0.2 * u, 0.5 * np.sin(0.1 * u), 0.02 * np.sin(0.3 * u)])
        pts = syn.lidar_scan(rng, world, t, R, N_RAYS)
        arr, valid = pad_to(pts, N_RAYS)
        out.append((arr, valid, pts.shape[0]))
    return out


def _pgo_config(Config):
    cfg = _config(Config, False)
    cfg.pgo_on = True
    cfg.global_loop_on = True
    cfg.pgo_freq = PGO_FREQ
    cfg._derive()
    return cfg


def _sync_pgo_from_jax(tsys, jsys):
    """_sync_from_jax plus the pose-graph back end."""
    from pin_slam_torch.slam import pgo as tpgo

    _sync_from_jax(tsys, jsys)
    tsys.dataset.pgo_poses = copy.deepcopy(jsys.dataset.pgo_poses)
    tsys.after_pgo = bool(jsys.after_pgo)
    tsys.loop_reg_failed_count = jsys.loop_reg_failed_count
    jg, tg = jsys.pgm, tsys.pgm
    tg.nodes = [n.copy() for n in jg.nodes]
    tg.edges = [tpgo.Edge(e.i, e.j, e.Z.copy(), e.info.copy()) for e in jg.edges]
    tg.fixed = list(jg.fixed)
    tg.min_loop_idx, tg.drift_radius = jg.min_loop_idx, jg.drift_radius
    tg.pgo_count, tg.last_loop_idx = jg.pgo_count, jg.last_loop_idx
    jsys.loop_mgr.materialize_pending()
    tm, jm = tsys.loop_mgr, jsys.loop_mgr
    tm.materialize_pending()
    tm.descriptors = [d.copy() for d in jm.descriptors]
    tm.ring_keys = [d.copy() for d in jm.ring_keys]
    tm.frame_ids = list(jm.frame_ids)


def _rot_err_deg(Ra, Rb):
    cos = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def test_forced_loop_closure_and_after_pgo_frames_match_jax(monkeypatch):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import Frame as TFrame
    from pin_slam_torch.slam import pipeline as tpl
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import Frame as JFrame
    from pin_slam_tpu.slam import pipeline as jpl
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    def forced(poses, travel, fid, *a, **k):
        return (LOOP_TO, 0.1) if fid == CLOSE_AT else (-1, np.inf)

    monkeypatch.setattr(jpl.ld, "detect_local_loop", forced)
    monkeypatch.setattr(tpl.ld, "detect_local_loop", forced)

    jsys = JSlam(_pgo_config(JConfig))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    tcfg = _pgo_config(TConfig)
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    tsys.tc = dataclasses.replace(tsys.tc, min_valid_ratio=0.1)
    assert tsys.pgm is not None and tsys.loop_mgr is not None

    for i, (arr, valid, n) in enumerate(_revisit_frames()):
        _sync_pgo_from_jax(tsys, jsys)
        j_info = jsys.process_frame(JFrame(arr, valid, None, None, None, n))
        t_info = tsys.process_frame(TFrame(arr, valid, n))
        if i > 0:
            assert j_info["reg_valid"] and t_info["reg_valid"], (i, j_info, t_info)
        assert t_info["loss_finite"], i
        assert t_info.get("pgo_applied", False) == j_info.get("pgo_applied", False), \
            (i, j_info, t_info)
        # the pose-graph books grow identically
        assert len(tsys.pgm.nodes) == len(jsys.pgm.nodes) == i + 1, (i, j_info, t_info)
        assert [(e.i, e.j) for e in tsys.pgm.edges] == [(e.i, e.j) for e in jsys.pgm.edges]

        if i == CLOSE_AT:
            assert j_info["pgo_applied"] and t_info["loop_candidate"] == LOOP_TO
            assert tsys.after_pgo and jsys.after_pgo
            Pj, Pt = np.stack(jsys.dataset.pgo_poses), np.stack(tsys.dataset.pgo_poses)
            np.testing.assert_allclose(Pt[:, :3, 3], Pj[:, :3, 3], atol=2e-3)
            assert max(_rot_err_deg(a[:3, :3], b[:3, :3]) for a, b in zip(Pj, Pt)) < 0.12
            # the closure moved the trajectory
            assert np.abs(Pt[:, :3, 3] - np.stack(tsys.dataset.odom_poses)[:, :3, 3]).max() > 1e-3
            ja, ta = np_(jsys.state.attr_rows), np_(tsys.state.attr_rows)
            cnt = int(jsys.state.count)
            assert int(tsys.state.count) == cnt
            np.testing.assert_allclose(ta[:cnt, :3], ja[:cnt, :3], atol=2e-3)
            np.testing.assert_allclose(ta[:cnt, 3:7], ja[:cnt, 3:7], atol=2e-3)
            assert np.abs(ta[:cnt, 4:7]).max() > 1e-5            # non-identity quaternions
            jh, th = np_(jsys.state.hash_table), np_(tsys.state.hash_table)
            occ = (jh < tsys.mc.capacity) | (th < tsys.mc.capacity)
            assert (jh[occ] == th[occ]).mean() >= 0.995
            jp, tp = np_(jsys.pool.rows), np_(tsys.pool.rows)
            fill = int(jsys.pool.fill)
            assert int(tsys.pool.fill) == fill
            np.testing.assert_array_equal(tp[:fill, 5], jp[:fill, 5])        # frame ids
            # rows of earlier frames: retransformed and refreshed, same samples
            # and neighbour sets; the closure frame's own samples were drawn at
            # the optimised pose, which differs by ~1e-4 m between the packages
            old = tp[:fill, 5] < CLOSE_AT
            np.testing.assert_array_equal(tp[:fill][old, 3:5], jp[:fill][old, 3:5])
            np.testing.assert_array_equal(tp[:fill][old, 9:15], jp[:fill][old, 9:15])
            assert (tp[:fill][~old, 9:15] == jp[:fill][~old, 9:15]).all(1).mean() > 0.99
            np.testing.assert_allclose(tp[:fill, 3:5], jp[:fill, 3:5], atol=1e-3)
            np.testing.assert_allclose(tp[:fill, :3], jp[:fill, :3], atol=2e-3)
            np.testing.assert_allclose(tp[:fill][old, 15:], jp[:fill][old, 15:], atol=2e-2)
        else:
            assert "pgo_applied" not in t_info and "pgo_applied" not in j_info

        Tj, Tt = jsys.cur_pose, tsys.cur_pose
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.02, (i, Tj[:3, 3], Tt[:3, 3])
        assert _rot_err_deg(Tj[:3, :3], Tt[:3, :3]) < 0.2, i
        for a, b in ((int(tsys.state.count), int(jsys.state.count)),
                     (int(tsys.pool.fill), int(jsys.pool.fill))):
            assert abs(a - b) <= 0.05 * b, (i, a, b)
        # the stage table carries the pgo column
        assert len(tsys.stage_times[-1]) == 5 and tsys.stage_times[-1][4] >= 0.0
    assert tsys.after_pgo and len(tsys.loop_mgr.frame_ids) > 0


def test_pgo_results_written(tmp_path):
    """write_results writes the pose-graph trajectory when PGO is on."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset

    cfg = _pgo_config(Config)
    ds = SLAMDataset(cfg, scans=[np.zeros((4, 3), np.float32)] * 2,
                     gt_poses=np.tile(np.eye(4), (2, 1, 1)))
    for i in range(2):
        T = np.eye(4)
        T[0, 3] = 0.5 * i
        ds.update_odom_pose(T, True)
    moved = np.stack(ds.pgo_poses).copy()
    moved[:, 1, 3] += 0.25
    ds.update_poses_after_pgo(moved)
    np.testing.assert_array_equal(ds.last_pose, moved[-1])
    ds.write_results(str(tmp_path))
    est = np.loadtxt(tmp_path / "odom_poses_kitti.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(est[:, 1, 3], [0.25, 0.25])
    assert len(ds) == 2 and ds.gt_pose_provided


@pytest.mark.slow
def test_square_loop_with_pgo():
    """tests/test_full_slam.py::test_square_loop_with_pgo on the port: the
    seed-7 square loop (in memory), local loop detection, its thresholds.
    ATE here is the unaligned position RMSE (the JAX test aligns first, so
    this gate is at least as strict)."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    scans, gt = syn.make_square_scene(np.random.default_rng(7))
    cfg = Config()
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.bs, cfg.iters, cfg.reg_iter_n = 8192, 15, 100
    cfg.silence, cfg.pgo_on, cfg.global_loop_on = True, True, False
    cfg.pgo_freq, cfg.min_loop_travel_dist_ratio = 4, 1.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 18, 1 << 16
    cfg.buffer_size, cfg.frame_bucket, cfg.source_bucket = 1 << 21, 1 << 14, 1 << 12
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 19, 1 << 19
    cfg._derive()
    system = SlamSystem(cfg, dataset=SLAMDataset(cfg, scans=scans, gt_poses=gt),
                        device="cuda" if torch.cuda.is_available() else "cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    system.tc_loop = dataclasses.replace(system.tc_loop, min_valid_ratio=0.08)
    for i in range(len(scans)):
        system.process_frame(system.dataset.preprocess_frame(i))
    assert [e for e in system.pgm.edges if abs(e.j - e.i) > 1], "no loop factor was added"
    assert system.after_pgo, "PGO never applied"
    est = np.stack(system.dataset.pgo_poses)
    odom = np.stack(system.dataset.odom_poses)
    err = np.linalg.norm(est[:, :3, 3] - gt[:len(est), :3, 3], axis=1)
    end_odom = np.linalg.norm(odom[-1, :3, 3] - gt[len(odom) - 1, :3, 3])
    assert err[-1] <= end_odom + 0.5, (err[-1], end_odom)
    assert err[-1] < 0.3, f"endpoint error {err[-1]:.3f} m"
    assert np.sqrt(np.mean(err ** 2)) < 0.15
