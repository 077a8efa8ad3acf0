"""The port's pose-graph optimiser (pin_slam_torch/slam/pgo.py, numpy and
scipy only) against the JAX package's on the drifting square of
tests/test_pgo.py: optimised poses, pose corrections and drift estimates
agree to 1e-9 in float64."""

import numpy as np
import pytest

from pin_slam_torch.slam import pgo as tpgo
from pin_slam_tpu.slam import pgo as jpgo


def _square(n_per_side=10, side=10.0):
    poses, T = [], np.eye(4)
    step = side / n_per_side
    for _ in range(4):
        for _ in range(n_per_side):
            poses.append(T.copy())
            T = T @ jpgo.se3_exp(np.array([0, 0, 0, step, 0, 0]))
        T = T @ jpgo.se3_exp(np.array([0, 0, np.pi / 2, 0, 0, 0]))
    poses.append(T.copy())
    return np.stack(poses)


def _graph(mod, with_cov):
    gt = _square()
    n = len(gt)
    pgm = mod.PoseGraphManager()
    est = [np.eye(4)]
    pgm.add_frame_node(0, est[0])
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i] @ jpgo.se3_exp(
            np.array([0, 0, 0.004, 0.01, 0, 0]))
        est.append(est[-1] @ rel)
        pgm.add_frame_node(i, est[-1])
        cov = None
        if with_cov:
            a = np.random.default_rng(i).normal(size=(6, 6)) * 1e-3
            cov = a @ a.T + 1e-4 * np.eye(6)
        pgm.add_odometry_factor(i, i - 1, rel, cov)
    pgm.add_loop_factor(n - 1, 0, np.linalg.inv(gt[0]) @ gt[-1])
    return pgm, np.stack(est), gt


@pytest.mark.parametrize("with_cov", [False, True], ids=["diag_info", "reg_cov"])
def test_pose_graph_matches_jax(with_cov):
    jp, est, gt = _graph(jpgo, with_cov)
    tp, _, _ = _graph(tpgo, with_cov)
    oj, ot = jp.optimize_pose_graph(), tp.optimize_pose_graph()
    np.testing.assert_allclose(ot, oj, atol=1e-9, rtol=0)
    np.testing.assert_allclose(tp.get_pose_diff(est), jp.get_pose_diff(est), atol=1e-9, rtol=0)
    travel = list(np.cumsum(np.r_[0.0, np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)]))
    assert abs(tp.estimate_drift(travel, len(gt) - 1)
               - jp.estimate_drift(travel, len(gt) - 1)) < 1e-12
    # and the optimisation did its job on the port too
    assert np.linalg.norm(ot[-1][:3, 3] - gt[-1][:3, 3]) < 0.05
    assert tp.min_loop_idx == jp.min_loop_idx == 0 and tp.pgo_count == 1


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(20, 6)) * 0.5
    np.testing.assert_allclose(tpgo.se3_exp_batch(xi), jpgo.se3_exp_batch(xi), atol=1e-12)
    T = jpgo.se3_exp_batch(xi)
    np.testing.assert_allclose(tpgo.se3_log_batch(T), jpgo.se3_log_batch(T), atol=1e-12)
    np.testing.assert_allclose(tpgo.adjoint_batch(T), jpgo.adjoint_batch(T), atol=1e-12)
    np.testing.assert_allclose(tpgo.se3_log(T[3]), xi[3], atol=1e-8)


def test_write_g2o_matches_jax(tmp_path):
    for mod, name in ((jpgo, "j.g2o"), (tpgo, "t.g2o")):
        pgm = mod.PoseGraphManager()
        pgm.add_frame_node(0, np.eye(4))
        T1 = jpgo.se3_exp(np.array([0, 0, 0.1, 1.0, 0, 0]))
        pgm.add_frame_node(1, T1)
        pgm.add_odometry_factor(1, 0, T1)
        pgm.write_g2o(str(tmp_path / name))
    assert (tmp_path / "j.g2o").read_text() == (tmp_path / "t.g2o").read_text()
