"""RGB-D dataset converters, the port's copy of
``pin_slam_tpu/dataset/converters.py``: Replica, TUM RGB-D and NeuralRGBD
folders -> per-frame back-projected PLY (``rgbd_ply/*.ply``, x y z + RGB)
and KITTI-format poses (``poses.txt``), so RGB-D sequences run through the
LiDAR pipeline (``dataset/indexing.py`` names ``replica`` / ``tum`` /
``neuralrgbd``).  Numpy only; the image reader imports PIL inside
``_load_image``, so nothing else of the port needs it.

    python -m pin_slam_torch.dataset.converters replica Replica/room0 Replica/room0
    python -m pin_slam_torch.dataset.converters tum <seq> <out> [--max_frames N]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from pin_slam_torch.dataset import io as pio

# Replica's camera (1200 x 680, as in the NICE-SLAM / Co-SLAM configurations)
REPLICA_FX = REPLICA_FY = 600.0
REPLICA_CX, REPLICA_CY = 599.5, 339.5
REPLICA_DEPTH_SCALE = 6553.5


def backproject_depth(depth: np.ndarray, fx: float, fy: float, cx: float, cy: float,
                      color: Optional[np.ndarray] = None, depth_scale: float = 1.0,
                      max_depth: float = 10.0, stride: int = 1
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Depth image [H, W] (and colour [H, W, 3]) -> camera-frame points
    (float32) and their colours (uint8 images become float32 in [0, 1]),
    every ``stride``-th pixel with 0 < depth < ``max_depth``."""
    d = depth.astype(np.float64) / depth_scale
    H, W = d.shape
    vs, us = np.meshgrid(np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij")
    z = d[vs, us]
    ok = (z > 0) & (z < max_depth)
    z = z[ok]
    u, v = us[ok], vs[ok]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = np.stack([x, y, z], axis=1).astype(np.float32)
    cols = None
    if color is not None:
        cols = color[vs, us][ok]
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float32) / 255.0
    return pts, cols


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


def convert_replica(seq_dir: str, out_dir: str, max_frames: Optional[int] = None,
                    depth_scale: float = REPLICA_DEPTH_SCALE, stride: int = 2) -> int:
    """Replica (``results/frameXXXXXX.jpg`` + ``depthXXXXXX.png`` +
    ``traj.txt``) -> ``rgbd_ply/*.ply`` + ``poses.txt``.  Returns the frame
    count."""
    fx, fy, cx, cy = REPLICA_FX, REPLICA_FY, REPLICA_CX, REPLICA_CY
    res_dir = os.path.join(seq_dir, "results")
    traj = np.loadtxt(os.path.join(seq_dir, "traj.txt")).reshape(-1, 4, 4)
    os.makedirs(os.path.join(out_dir, "rgbd_ply"), exist_ok=True)

    n = len(traj) if max_frames is None else min(len(traj), max_frames)
    poses = []
    for i in range(n):
        depth = _load_image(os.path.join(res_dir, f"depth{i:06d}.png"))
        rgb_path = os.path.join(res_dir, f"frame{i:06d}.jpg")
        color = _load_image(rgb_path) if os.path.exists(rgb_path) else None
        pts, cols = backproject_depth(depth, fx, fy, cx, cy, color,
                                      depth_scale=depth_scale, stride=stride)
        pio.write_ply(os.path.join(out_dir, "rgbd_ply", f"{i:06d}.ply"), pts, colors=cols)
        poses.append(traj[i])
    pio.write_kitti_poses(os.path.join(out_dir, "poses.txt"), np.stack(poses))
    return n


def convert_tum(seq_dir: str, out_dir: str, max_frames: Optional[int] = None,
                depth_scale: float = 5000.0, stride: int = 2,
                max_dt: float = 0.02) -> int:
    """TUM RGB-D (``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt``) ->
    ``rgbd_ply`` + ``poses.txt``: each colour image is paired with the
    nearest depth image and ground-truth pose (both within ``max_dt`` s),
    back-projected with TUM's default intrinsics.  Returns the frame count."""
    fx, fy, cx, cy = 525.0, 525.0, 319.5, 239.5

    def read_list(name):
        out = []
        with open(os.path.join(seq_dir, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out.append((float(parts[0]), parts[1:]))
        return out

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    gt_poses, gt_ts = pio.read_tum_poses(os.path.join(seq_dir, "groundtruth.txt"))

    os.makedirs(os.path.join(out_dir, "rgbd_ply"), exist_ok=True)
    d_ts = np.asarray([t for t, _ in depth])
    poses = []
    count = 0
    for t_rgb, rgb_file in rgb:
        j = int(np.argmin(np.abs(d_ts - t_rgb)))
        if abs(d_ts[j] - t_rgb) > max_dt:
            continue
        k = int(np.argmin(np.abs(gt_ts - t_rgb)))
        if abs(gt_ts[k] - t_rgb) > max_dt:
            continue
        dimg = _load_image(os.path.join(seq_dir, depth[j][1][0]))
        cimg = _load_image(os.path.join(seq_dir, rgb_file[0]))
        pts, cols = backproject_depth(dimg, fx, fy, cx, cy, cimg,
                                      depth_scale=depth_scale, stride=stride)
        pio.write_ply(os.path.join(out_dir, "rgbd_ply", f"{count:06d}.ply"), pts, colors=cols)
        poses.append(gt_poses[k])
        count += 1
        if max_frames is not None and count >= max_frames:
            break
    if poses:
        pio.write_kitti_poses(os.path.join(out_dir, "poses.txt"), np.stack(poses))
    return count


def convert_neuralrgbd(seq_dir: str, out_dir: str, max_frames: Optional[int] = None,
                       depth_scale: float = 1000.0, stride: int = 2) -> int:
    """NeuralRGBD (``images/``, ``depth_filtered/`` or ``depth/``,
    ``poses.txt``, ``focal.txt``) -> ``rgbd_ply`` + ``poses.txt``; the
    OpenGL-style camera poses get their y and z axes flipped.  Returns the
    frame count."""
    with open(os.path.join(seq_dir, "focal.txt")) as f:
        focal = float(f.read().split()[0])
    depth_dir = os.path.join(seq_dir, "depth_filtered")
    if not os.path.isdir(depth_dir):
        depth_dir = os.path.join(seq_dir, "depth")
    img_dir = os.path.join(seq_dir, "images")
    depth_files = pio.natural_sort([f for f in os.listdir(depth_dir) if f.endswith(".png")])
    img_files = (pio.natural_sort([f for f in os.listdir(img_dir)
                                   if f.endswith((".png", ".jpg"))])
                 if os.path.isdir(img_dir) else [])
    traj = np.loadtxt(os.path.join(seq_dir, "poses.txt")).reshape(-1, 4, 4)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    os.makedirs(os.path.join(out_dir, "rgbd_ply"), exist_ok=True)

    n = min(len(depth_files), len(traj))
    if max_frames is not None:
        n = min(n, max_frames)
    poses = []
    for i in range(n):
        dimg = _load_image(os.path.join(depth_dir, depth_files[i]))
        H, W = dimg.shape[:2]
        cimg = (_load_image(os.path.join(img_dir, img_files[i]))
                if i < len(img_files) else None)
        pts, cols = backproject_depth(dimg, focal, focal, W / 2 - 0.5, H / 2 - 0.5,
                                      cimg, depth_scale=depth_scale, stride=stride)
        pio.write_ply(os.path.join(out_dir, "rgbd_ply", f"{i:06d}.ply"), pts, colors=cols)
        poses.append(traj[i] @ flip)
    pio.write_kitti_poses(os.path.join(out_dir, "poses.txt"), np.stack(poses))
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="RGB-D sequence -> rgbd_ply/*.ply + poses.txt")
    ap.add_argument("dataset", choices=["replica", "tum", "neuralrgbd"])
    ap.add_argument("input_root")
    ap.add_argument("output_root")
    ap.add_argument("--max_frames", type=int, default=None)
    args = ap.parse_args(argv)
    fn = {"replica": convert_replica, "tum": convert_tum,
          "neuralrgbd": convert_neuralrgbd}[args.dataset]
    n = fn(args.input_root, args.output_root, max_frames=args.max_frames)
    print(f"converted {n} {args.dataset} frames of {args.input_root} -> {args.output_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
