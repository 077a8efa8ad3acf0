"""Frame pipeline + host pose books, torch-port counterpart of
``pin_slam_tpu/dataset/slam_dataset.py``: KITTI frame discovery and
preprocessing (range crop, adaptive or fixed, bucket cap), the
constant-velocity initial guess, odometry and pose-graph poses, travel
distance, stop and lose-track detection."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pin_slam_torch.dataset import io as pio
from pin_slam_torch.ops.transforms import np_se3_inverse
from pin_slam_torch.ops.voxel import pad_to
from pin_slam_torch.utils.platform import not_ported

PC_EXTS = {".bin", ".npy"}


class Frame:
    """One preprocessed frame, padded to the frame bucket (numpy, host)."""

    def __init__(self, points, valid, raw_count):
        self.points = points          # (B,3) f32 sensor frame
        self.valid = valid            # (B,) bool
        self.raw_count = raw_count


class SLAMDataset:
    """Frames from ``config.pc_path`` (KITTI ``.bin`` / ``.npy``) and ground
    truth from ``config.pose_path``, or, when ``scans`` is given, frames held
    in memory ((N, >=3) float arrays, sensor frame) with optional ground-truth
    poses ``gt_poses`` (n, 4, 4)."""

    def __init__(self, config, scans: Optional[List[np.ndarray]] = None,
                 gt_poses: Optional[np.ndarray] = None):
        self.config = config
        if config.deskew:
            raise not_ported("deskew with per-point timestamps")
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
            if config.calib_path and os.path.exists(config.calib_path):
                raise not_ported("KITTI calibration of GT poses")
            poses = pio.read_kitti_poses(config.pose_path)
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

    def preprocess_frame(self, frame_id: int) -> Frame:
        """Read + range/z crop + random cap at the frame bucket, padded."""
        cfg = self.config
        if cfg.kitti_correction_on and cfg.correction_deg != 0.0:
            raise not_ported("KITTI intrinsic correction")
        if self.scans is not None:
            points = np.asarray(self.scans[frame_id])[:, :3].astype(np.float32)
        else:
            points, _, _ = pio.read_point_cloud(self.pc_filenames[frame_id])
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
        points = points[keep]
        rng = np.random.default_rng(cfg.seed + frame_id)
        if cfg.rand_downsample and cfg.rand_down_r < 1.0:
            points = points[rng.random(points.shape[0]) < cfg.rand_down_r]
        bucket = cfg.frame_bucket
        if points.shape[0] > bucket:
            points = points[rng.choice(points.shape[0], bucket, replace=False)]
        pad_pts, valid = pad_to(points.astype(np.float32), bucket)
        return Frame(pad_pts, valid, points.shape[0])

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

    def write_results(self, run_path: str) -> None:
        """The trajectory (pose-graph poses when PGO is on, else odometry) in
        KITTI format, and the stage time table."""
        os.makedirs(run_path, exist_ok=True)
        poses = self.pgo_poses if self.config.pgo_on else self.odom_poses
        pio.write_kitti_poses(os.path.join(run_path, "odom_poses_kitti.txt"),
                              np.asarray(poses))
        if self.time_table:
            np.save(os.path.join(run_path, "time_table.npy"), np.asarray(self.time_table))
