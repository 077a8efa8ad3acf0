"""Trajectory evaluation, the port's copy of ``pin_slam_tpu/eval/traj.py``:
ATE after a Horn/Umeyama alignment, KITTI relative drift, and the
trajectory plots (skipped when matplotlib is absent).  Pure numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def align_umeyama(gt_xyz: np.ndarray, est_xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form SE(3) alignment (Horn/Umeyama, no scale)
    (ref eval/eval_traj_utils.py:66-101).  Returns (R, t) mapping est -> gt."""
    mu_g = gt_xyz.mean(0)
    mu_e = est_xyz.mean(0)
    X = est_xyz - mu_e
    Y = gt_xyz - mu_g
    C = Y.T @ X / gt_xyz.shape[0]
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_g - R @ mu_e
    return R, t


def absolute_error(gt_poses: np.ndarray, est_poses: np.ndarray,
                   align: bool = True) -> Tuple[float, float]:
    """ATE RMSE (m) and mean rotation error (deg)
    (ref eval/eval_traj_utils.py:13-56)."""
    n = min(len(gt_poses), len(est_poses))
    gt, est = np.asarray(gt_poses)[:n], np.asarray(est_poses)[:n]
    gt_xyz, est_xyz = gt[:, :3, 3], est[:, :3, 3]
    if align and n >= 3:
        R, t = align_umeyama(gt_xyz, est_xyz)
    else:
        R, t = np.eye(3), np.zeros(3)
    est_aligned = est_xyz @ R.T + t
    ate_rmse = float(np.sqrt(np.mean(np.sum((est_aligned - gt_xyz) ** 2, axis=1))))

    rot_errs = []
    for i in range(n):
        dR = (R @ est[i, :3, :3]).T @ gt[i, :3, :3]
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0)))
        rot_errs.append(ang)
    return ate_rmse, float(np.mean(rot_errs))


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def relative_error(gt_poses: np.ndarray, est_poses: np.ndarray,
                   lengths: List[float] = (100, 200, 300, 400, 500, 600, 700, 800),
                   step: int = 10) -> Tuple[float, float]:
    """KITTI average relative drift over 100..800 m segments: (%, deg/m)
    (ref eval/eval_traj_utils.py:103-166)."""
    n = min(len(gt_poses), len(est_poses))
    gt, est = np.asarray(gt_poses)[:n], np.asarray(est_poses)[:n]
    dist = _trajectory_distances(gt)

    errs_t, errs_r = [], []
    for first in range(0, n, step):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            dT_gt = np.linalg.inv(gt[first]) @ gt[last]
            dT_est = np.linalg.inv(est[first]) @ est[last]
            E = np.linalg.inv(dT_est) @ dT_gt
            t_err = np.linalg.norm(E[:3, 3]) / length
            r_err = np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))) / length
            errs_t.append(t_err)
            errs_r.append(r_err)
    if not errs_t:
        return 0.0, 0.0
    return float(np.mean(errs_t) * 100.0), float(np.mean(errs_r))


def plot_trajectories(run_path: str, est_poses: np.ndarray,
                      gt_poses: np.ndarray = None) -> None:
    """2-D (xy) and 3-D trajectory plot artifacts, estimate vs ground truth
    (ref dataset/slam_dataset.py:554-558, eval/eval_traj_utils.py:233-297,
    evo-free).  Writes ``traj_plot_2d.png`` and ``traj_plot_3d.png``."""
    import os

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    est = np.asarray(est_poses)
    xyz = est[:, :3, 3]
    gt_xyz = np.asarray(gt_poses)[:, :3, 3] if gt_poses is not None else None

    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], "--", color="gray", lw=1, label="ground truth")
    ax.plot(xyz[:, 0], xyz[:, 1], "-", color="tab:blue", lw=1.2, label="estimate")
    ax.plot(xyz[0, 0], xyz[0, 1], "k^", ms=6, label="start")
    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(run_path, "traj_plot_2d.png"), dpi=120)
    plt.close(fig)

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    if gt_xyz is not None:
        ax.plot(gt_xyz[:, 0], gt_xyz[:, 1], gt_xyz[:, 2], "--", color="gray",
                lw=1, label="ground truth")
    ax.plot(xyz[:, 0], xyz[:, 1], xyz[:, 2], "-", color="tab:blue", lw=1.2,
            label="estimate")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(os.path.join(run_path, "traj_plot_3d.png"), dpi=120)
    plt.close(fig)
