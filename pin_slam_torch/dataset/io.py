"""KITTI-format readers/writers the main path needs (the port's own copy of
the framework-free parts of ``pin_slam_tpu/dataset/io.py``)."""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np


def natural_sort(names: List[str]) -> List[str]:
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]
    return sorted(names, key=key)


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: [N,4] x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """(points [N,3], intensity [N,1], timestamps None); only KITTI .bin and
    .npy are ported."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        raw = read_kitti_bin(path)
        return raw[:, :3], raw[:, 3:4], None
    if ext == ".npy":
        raw = np.load(path)
        return (raw[:, :3].astype(np.float32),
                raw[:, 3:4].astype(np.float32) if raw.shape[1] > 3 else None, None)
    from pin_slam_torch.utils.platform import not_ported

    raise not_ported(f"point cloud format {ext}")


def read_kitti_poses(path: str) -> np.ndarray:
    """Each line 12 floats (3x4 row-major), optionally led by a timestamp.
    Returns [N,4,4] float64."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    if data.shape[1] == 13:
        data = data[:, 1:]
    n = data.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :] = data.reshape(n, 3, 4)
    return poses


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9f}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")
