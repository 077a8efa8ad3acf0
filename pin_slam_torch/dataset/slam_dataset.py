"""Frame pipeline + host pose books, torch-port counterpart of
``pin_slam_tpu/dataset/slam_dataset.py``: frame discovery (KITTI ``.bin``,
``.npy``, PLY, PCD), ground truth (KITTI or TUM poses, moved into the LiDAR
frame by a KITTI calibration file), preprocessing (KITTI's intrinsic
correction, range crop, adaptive or fixed, bucket cap, and deskewing with
per-point timestamps, read from the file or recovered from the scan's yaw,
in torch on the dataset's device; with ``color_on`` each point's colour
rides along, with ``semantic_on`` its SemanticKITTI class, read from
``label_path``, reduced to the learning classes, with outliers and, under
``filter_moving_object``, moving objects dropped), the constant-velocity
initial guess,
odometry and pose-graph poses, travel distance, stop and lose-track
detection, and the end-of-run results: the trajectory with its evaluation
against ground truth, and the merged point cloud."""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np
import torch

from pin_slam_torch.dataset import io as pio
from pin_slam_torch.ops.transforms import deskew_points, np_se3_inverse
from pin_slam_torch.ops.voxel import pad_to
from pin_slam_torch.utils.semantic_kitti import apply_learning_map
from pin_slam_torch.utils import tracing
from pin_slam_torch.utils.platform import resolve_device

PC_EXTS = {".bin", ".ply", ".pcd", ".npy"}


class Frame:
    """One preprocessed frame, padded to the frame bucket (numpy, host)."""

    def __init__(self, points, valid, raw_count, point_ts=None, colors=None,
                 sem_labels=None):
        self.points = points          # (B,3) f32 sensor frame
        self.valid = valid            # (B,) bool
        self.raw_count = raw_count
        self.point_ts = point_ts      # (B,) f32 per-point time or None
        self.colors = colors          # (B,C) f32 colours (color_on) or None
        self.sem_labels = sem_labels  # (B,) int32 learning classes (semantic_on) or None


class SLAMDataset:
    """Frames from ``config.pc_path`` and ground truth from
    ``config.pose_path`` (through ``config.calib_path``'s ``Tr`` when that
    file exists), or, when ``scans`` is given, frames held in memory ((N, >=3)
    float arrays, sensor frame: x, y, z, then intensity, then each point's
    time, as a file's ``t`` / ``time`` field carries it) with optional
    ground-truth poses ``gt_poses`` (n, 4, 4).  With ``config.deskew`` the
    frames are deskewed on ``device`` (None: the GPU, raising without one;
    ``SlamSystem`` passes its own)."""

    def __init__(self, config, scans: Optional[List[np.ndarray]] = None,
                 gt_poses: Optional[np.ndarray] = None, device=None):
        self.config = config
        self.device = resolve_device(device) if config.deskew else device
        self.scans = scans
        self.pc_filenames: List[str] = []
        if scans is None and config.pc_path and os.path.isdir(config.pc_path):
            self.pc_filenames = [
                os.path.join(config.pc_path, f)
                for f in pio.natural_sort(os.listdir(config.pc_path))
                if os.path.splitext(f)[1].lower() in PC_EXTS]
        self.total_pc_count = len(self.pc_filenames) if scans is None else len(scans)

        self.gt_poses: Optional[np.ndarray] = None
        self.gt_pose_provided = False
        if gt_poses is not None:
            self.gt_poses = np.asarray(gt_poses, np.float64)
            self.gt_pose_provided = True
        elif config.pose_path and os.path.exists(config.pose_path):
            if config.pose_path.endswith(".txt"):
                try:
                    poses = pio.read_kitti_poses(config.pose_path)
                except ValueError:
                    poses, _ = pio.read_tum_poses(config.pose_path)
            else:
                poses, _ = pio.read_tum_poses(config.pose_path)
            calib = None
            if config.calib_path and os.path.exists(config.calib_path):
                calib = pio.read_kitti_calib(config.calib_path).get("Tr")
            if calib is not None:
                poses = pio.apply_kitti_calib(poses, calib)
            if config.first_frame_ref:
                poses = np.einsum("ij,njk->nik", np_se3_inverse(poses[0]), poses)
            self.gt_poses = poses
            self.gt_pose_provided = True

        self.odom_poses: List[np.ndarray] = []
        self.pgo_poses: List[np.ndarray] = []     # odometry, corrected by each PGO
        self.travel_dist: List[float] = [0.0]
        self.last_pose = np.eye(4)
        self.last_odom_tran = np.eye(4)
        self.stop_status = False
        self.lose_track = False
        self.consecutive_lose_track_frame = 0
        self.stop_count = 0
        self.time_table: List[List[float]] = []
        self.processed_frame = 0

    def __len__(self):
        return self.total_pc_count

    def read_frame(self, frame_id: int):
        """(points (N,3) float32, intensity / colours (N,C) or None, per-point
        timestamps (N,) or None, semantic classes (N,) int32 or None) of a
        frame.  With ``semantic_on`` and a ``<label_path>/<frame>.label``
        file, the raw SemanticKITTI ids become the 20 learning classes and
        the points with raw id 0 or 1 (unlabeled, outlier) are dropped, and
        under ``filter_moving_object`` those of the moving classes (raw id
        >= 100) too.  With ``deskew`` on, a frame whose file carries no
        timestamps gets them from its scan yaw.  A scan held in memory
        carries its intensity in column 3 and its points' times in column 4."""
        sem = None
        if self.scans is not None:
            scan = np.asarray(self.scans[frame_id])
            points = scan[:, :3].astype(np.float32)
            colors = scan[:, 3:4].astype(np.float32) if scan.shape[1] > 3 else None
            ts = scan[:, 4].astype(np.float32) if scan.shape[1] > 4 else None
        else:
            path = self.pc_filenames[frame_id]
            points, colors, ts = pio.read_point_cloud(path)
            cfg = self.config
            lab_path = (os.path.join(cfg.label_path,
                                     os.path.splitext(os.path.basename(path))[0] + ".label")
                        if cfg.semantic_on and cfg.label_path else "")
            if lab_path and os.path.exists(lab_path):
                raw = pio.read_semantic_labels(lab_path)
                if raw.shape[0] != points.shape[0]:
                    raise ValueError(f"{lab_path}: {raw.shape[0]} labels for "
                                     f"{points.shape[0]} points")
                sem = apply_learning_map(raw)
                inlier = raw > 1
                if cfg.filter_moving_object:
                    inlier &= raw < 100
                points, colors, ts, sem = _take_all(inlier, points, colors, ts, sem)
        if ts is None and self.config.deskew:
            ts = recover_point_ts(points, self.config.lidar_type_guess)
        return points, colors, ts, sem

    def preprocess_frame(self, frame_id: int) -> Frame:
        """Read + intrinsic correction + range/z crop + random cap at the
        frame bucket + deskew with the last relative motion, padded.  With
        ``color_on`` the file's colours follow their points through every
        step (the voxel downsample runs on the device, in the pipeline), and
        so do the semantic classes."""
        with tracing.span("pin_slam.dataset.preprocess"):
            cfg = self.config
            points, colors, ts, sem = self.read_frame(frame_id)
            if not cfg.color_on:
                colors = None
            if cfg.kitti_correction_on and cfg.correction_deg != 0.0:
                points = intrinsic_correct(points, cfg.correction_deg)
            # adaptive crop range (used for NCD): twice the scan's smaller
            # horizontal half-extent, at most max_range
            crop_max_range = cfg.max_range
            if cfg.adaptive_range_on and points.shape[0] > 0:
                pc_max, pc_min = points.max(axis=0), points.min(axis=0)
                min_x_range = min(abs(pc_max[0]), abs(pc_min[0]))
                min_y_range = min(abs(pc_max[1]), abs(pc_min[1]))
                crop_max_range = min(cfg.max_range, 2.0 * max(min_x_range, min_y_range))
            d = np.linalg.norm(points, axis=1)
            keep = ((d > cfg.min_range) & (d < crop_max_range)
                    & (points[:, 2] > cfg.min_z) & (points[:, 2] < cfg.max_z))
            points, colors, ts, sem = _take_all(keep, points, colors, ts, sem)
            rng = np.random.default_rng(cfg.seed + frame_id)
            if cfg.rand_downsample and cfg.rand_down_r < 1.0:
                sel = rng.random(points.shape[0]) < cfg.rand_down_r
                points, colors, ts, sem = _take_all(sel, points, colors, ts, sem)
            bucket = cfg.frame_bucket
            if points.shape[0] > bucket:
                sel = rng.choice(points.shape[0], bucket, replace=False)
                points, colors, ts, sem = _take_all(sel, points, colors, ts, sem)
            if cfg.deskew and ts is not None and self.processed_frame > 0:
                dev = self.device
                with tracing.span("pin_slam.dataset.deskew"):
                    points = tracing.read(deskew_points(
                        tracing.upload(points, "points", dev, torch.float32),
                        tracing.upload(np.asarray(ts, np.float32), "times", dev),
                        tracing.upload(self.last_odom_tran, "motion", dev, torch.float32)),
                        "deskewed").numpy()
            pad_pts, valid = pad_to(points.astype(np.float32), bucket)
            pad_ts = pad_to(ts.astype(np.float32), bucket)[0] if ts is not None else None
            pad_col = pad_to(colors.astype(np.float32), bucket)[0] if colors is not None else None
            pad_sem = pad_to(sem.astype(np.int32), bucket)[0] if sem is not None else None
            return Frame(pad_pts, valid, points.shape[0], pad_ts, pad_col, pad_sem)

    def initial_guess(self) -> np.ndarray:
        """Constant-velocity initial guess."""
        if not self.config.uniform_motion_on or len(self.odom_poses) == 0:
            return self.last_pose.copy()
        return self.last_pose @ self.last_odom_tran

    def update_odom_pose(self, cur_pose: np.ndarray, valid: bool = True) -> None:
        """Pose books: travel distance, stop + lose-track detection."""
        cfg = self.config
        U, _, Vt = np.linalg.svd(cur_pose[:3, :3])
        cur_pose = cur_pose.copy()
        cur_pose[:3, :3] = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        if not valid:
            self.lose_track = True
            self.consecutive_lose_track_frame += 1
            cur_pose = self.initial_guess()
        else:
            self.lose_track = False
            self.consecutive_lose_track_frame = 0
        cur_odom_tran = np_se3_inverse(self.last_pose) @ cur_pose
        tran_m = float(np.linalg.norm(cur_odom_tran[:3, 3]))
        if tran_m > 40.0 * cfg.surface_sample_range_m and len(self.odom_poses) > 0:
            self.lose_track = True
            self.consecutive_lose_track_frame += 1
            cur_pose = self.initial_guess()
            cur_odom_tran = np_se3_inverse(self.last_pose) @ cur_pose
            tran_m = float(np.linalg.norm(cur_odom_tran[:3, 3]))
        self.travel_dist.append(self.travel_dist[-1] + tran_m)
        if tran_m < 0.01 * cfg.voxel_size_m:
            self.stop_count += 1
        else:
            self.stop_count = 0
        self.stop_status = self.stop_count > cfg.stop_frame_thre
        if not self.lose_track:
            self.last_odom_tran = cur_odom_tran
        self.odom_poses.append(cur_pose.copy())
        self.pgo_poses.append(cur_pose.copy())
        self.last_pose = cur_pose.copy()
        self.processed_frame += 1
        if self.consecutive_lose_track_frame > 20:
            raise RuntimeError("tracking lost for 20+ consecutive frames")

    def update_poses_after_pgo(self, pgo_poses: np.ndarray) -> None:
        """Replace the pose-graph poses by an optimisation's result."""
        self.pgo_poses = [pgo_poses[i].copy() for i in range(len(pgo_poses))]
        self.last_pose = self.pgo_poses[-1].copy()

    def write_results(self, run_path: str) -> dict:
        """The trajectory (pose-graph poses when PGO is on, else odometry) in
        KITTI and TUM formats, the stage time table, the trajectory plots,
        and with ground truth the ATE / drift metrics (``pose_eval.csv``),
        which it returns ({} without ground truth)."""
        from pin_slam_torch.eval.traj import absolute_error, plot_trajectories, relative_error

        os.makedirs(run_path, exist_ok=True)
        poses = np.asarray(self.pgo_poses if self.config.pgo_on else self.odom_poses)
        pio.write_kitti_poses(os.path.join(run_path, "odom_poses_kitti.txt"), poses)
        pio.write_tum_poses(os.path.join(run_path, "odom_poses_tum.txt"), poses)
        if self.time_table:
            np.save(os.path.join(run_path, "time_table.npy"), np.asarray(self.time_table))
        metrics = {}
        if self.gt_pose_provided and len(poses) > 1:
            gt = self.gt_poses[: len(poses)]
            ate_rmse, ate_rot = absolute_error(gt, poses, align=self.config.eval_traj_align)
            drift, drift_rot = relative_error(gt, poses)
            metrics = {"ate_rmse_m": ate_rmse, "ate_rot_deg": ate_rot,
                       "drift_percent": drift, "drift_deg_per_m": drift_rot}
            with open(os.path.join(run_path, "pose_eval.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(list(metrics.keys()))
                w.writerow([f"{v:.6f}" for v in metrics.values()])
            plot_trajectories(run_path, poses, gt)
        elif len(poses) > 1:
            plot_trajectories(run_path, poses)
        return metrics

    def write_merged_point_cloud(self, run_path: str, vox_down_m: float = 0.1,
                                 frame_stride: int = 2,
                                 max_points_per_frame: int = 30000) -> str:
        """Every ``frame_stride``-th frame, range-cropped and capped, through the
        final poses into one cloud with the first point of each
        ``vox_down_m`` voxel, intensity as grey (``map/merged_point_cloud.ply``)."""
        cfg = self.config
        poses = self.pgo_poses if cfg.pgo_on else self.odom_poses
        rng = np.random.default_rng(cfg.seed)
        worlds, cols = [], []
        for i in range(0, min(len(poses), self.total_pc_count), max(frame_stride, 1)):
            points, colors, _, _ = self.read_frame(i)
            d = np.linalg.norm(points, axis=1)
            keep = (d > cfg.min_range) & (d < cfg.max_range)
            points = points[keep]
            colors = colors[keep] if colors is not None else None
            if points.shape[0] > max_points_per_frame:
                sel = rng.choice(points.shape[0], max_points_per_frame, replace=False)
                points = points[sel]
                colors = colors[sel] if colors is not None else None
            T = poses[i]
            worlds.append(points @ T[:3, :3].T + T[:3, 3])
            cols.append(colors)
        pts = np.zeros((0, 3), np.float32)
        col = None
        if worlds:
            world = np.concatenate(worlds)
            keys = np.floor(world / vox_down_m).astype(np.int64)
            # the first point of every voxel, in order of first appearance
            _, first = np.unique(keys, axis=0, return_index=True)
            first = np.sort(first)
            pts = world[first].astype(np.float32)
            if first.size and cols[0] is not None:
                col = np.concatenate(cols)[first].astype(np.float32)
                if col.shape[1] == 1:                  # intensity -> grey RGB
                    col = np.repeat(col, 3, axis=1)
                if col.max(initial=0) > 1.0:
                    col = col / 255.0
        out = os.path.join(run_path, "map", "merged_point_cloud.ply")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        pio.write_ply(out, pts, colors=col)
        return out


def _take_all(sel, *arrays):
    """The rows ``sel`` (a mask or indices) of each array (None stays None)."""
    return tuple(a[sel] if a is not None else None for a in arrays)


def intrinsic_correct(points: np.ndarray, correct_deg: float = 0.0) -> np.ndarray:
    """KITTI's vertical-angle intrinsic correction (as in CT-ICP and
    IMLS-SLAM): lift each point's vertical angle by ``correct_deg``."""
    if correct_deg == 0.0:
        return points
    out = points.copy()
    dist = np.linalg.norm(points[:, :3], axis=1)
    v_ang = np.arcsin(np.clip(points[:, 2] / np.maximum(dist, 1e-12), -1.0, 1.0))
    v_ang_c = v_ang + np.radians(correct_deg)
    hor_scale = np.cos(v_ang_c) / np.maximum(np.cos(v_ang), 1e-12)
    out[:, 0] *= hor_scale
    out[:, 1] *= hor_scale
    out[:, 2] = dist * np.sin(v_ang_c)
    return out


def recover_point_ts(points: np.ndarray, lidar_type: str = "velodyne") -> np.ndarray:
    """Per-point time in [0, 1] from the scan yaw of a spinning LiDAR
    (clockwise sweep)."""
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    ts = (yaw / np.pi + 1.0) / 2.0
    return ts.astype(np.float32)
