"""Dataset name + sequence -> file paths: the port's copy of
``pin_slam_tpu/dataset/indexing.py`` (kitti, kitti_carla, mulran, ncd,
ncd128, ipbcar, ntu, hilti, eth_dynamic, m2dgr, replica, neuralrgbd, tum,
scannet)."""

from __future__ import annotations

import os


def set_dataset_path(config, dataset_name: str = "", seq: str = "") -> None:
    """Point ``config`` at a sequence of a named dataset under the root given
    in ``config.pc_path`` (frames, poses, calibration) and append the name
    and sequence to ``config.name``.  ``kitti`` also turns KITTI's 0.195 deg
    intrinsic correction on; the RGB-D names (sequences converted by
    ``dataset/converters.py``) turn the colour head on.  Raises ValueError
    for an unknown name."""
    config.name = f"{config.name}_{dataset_name}_{seq}" if dataset_name else config.name
    base = config.pc_path  # user supplies the dataset root in pc_path before dispatch

    d = dataset_name.lower()
    if d == "kitti":
        config.pc_path = os.path.join(base, "sequences", seq, "velodyne")
        config.pose_path = os.path.join(base, "poses", f"{seq}.txt")
        config.calib_path = os.path.join(base, "sequences", seq, "calib.txt")
        if config.semantic_on:
            config.label_path = os.path.join(base, "sequences", seq, "labels")
        config.kitti_correction_on = True
        config.correction_deg = 0.195
    elif d == "kitti_carla":
        config.pc_path = os.path.join(base, seq, "generated", "frames")
        config.pose_path = os.path.join(base, seq, "generated", "poses.txt")
        config.calib_path = os.path.join(base, seq, "generated", "calib.txt")
    elif d == "mulran":
        config.pc_path = os.path.join(base, seq, "Ouster")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.calib_path = os.path.join(base, seq, "calib.txt")
    elif d in ("ncd", "ncd128"):
        config.pc_path = os.path.join(base, seq, "bin" if d == "ncd" else "ply")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.calib_path = os.path.join(base, seq, "calib.txt")
    elif d == "ipbcar":
        config.pc_path = os.path.join(base, seq, "ouster")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.calib_path = os.path.join(base, seq, "calib.txt")
    elif d in ("ntu", "hilti", "eth_dynamic", "m2dgr"):
        config.pc_path = os.path.join(base, seq, "ply")
        config.pose_path = os.path.join(base, seq, "poses.txt")
    elif d in ("replica", "neuralrgbd", "tum", "scannet"):
        # RGB-D sets converted to per-frame back-projected PLY + KITTI poses
        config.pc_path = os.path.join(base, seq, "rgbd_ply")
        config.pose_path = os.path.join(base, seq, "poses.txt")
        config.color_map_on = True
        config.color_on = True
        config.color_channel = 3
    elif d:
        raise ValueError(f"unknown dataset name: {dataset_name}")
