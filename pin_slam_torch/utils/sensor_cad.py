"""Procedural sensor CAD glyphs for visualization, the port's copy of
``pin_slam_tpu/utils/sensor_cad.py`` (numpy only; the PLY writer is the
port's ``dataset/io.write_ply``).

The reference draws a sensor CAD model at the current pose in its live
visualizer (reference utils/visualizer.py + cad/*.ply, configured by
``sensor_cad_path`` in the profiles).  The reference's .ply assets are
artist-made binaries; here the equivalent glyphs (car, camera, drone,
generic lidar puck) are generated procedurally — same role, own geometry.

``write_all(cad_dir)`` materializes them as .ply so the shipped profiles'
``sensor_cad_path: ./cad/kitti_car.ply`` resolve; ``glyph(name)`` returns
(verts, faces) for direct drawing (viewer_html sensor layer).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def _box(cx, cy, cz, sx, sy, sz):
    """Axis-aligned box mesh centered at (cx,cy,cz)."""
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32) / 2
    v += np.array([cx, cy, cz], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return v, f


def _cylinder(cx, cy, cz, r, h, n=12):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    v = np.concatenate([
        np.column_stack([ring, np.full(n, cz - h / 2)]),
        np.column_stack([ring, np.full(n, cz + h / 2)]),
        [[cx, cy, cz - h / 2], [cx, cy, cz + h / 2]]]).astype(np.float32)
    f = []
    for i in range(n):
        j = (i + 1) % n
        f += [[i, j, n + i], [j, n + j, n + i],
              [2 * n, j, i], [2 * n + 1, n + i, n + j]]
    return v, np.asarray(f, np.int64)


def _merge(*meshes):
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def glyph(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(verts (N,3) f32, faces (M,3) i64), x-forward, z-up, meters."""
    if name in ("kitti_car", "ipb_car", "car"):
        return _merge(
            _box(0.0, 0.0, -1.0, 3.9, 1.7, 0.9),     # body (sensor ~1.45 m up)
            _box(-0.3, 0.0, -0.35, 1.9, 1.5, 0.6),   # cabin
            _cylinder(0.0, 0.0, -0.05, 0.12, 0.14),  # lidar puck on roof
            _cylinder(1.2, 0.85, -1.55, 0.32, 0.22, 10),   # wheels
            _cylinder(1.2, -0.85, -1.55, 0.32, 0.22, 10),
            _cylinder(-1.35, 0.85, -1.55, 0.32, 0.22, 10),
            _cylinder(-1.35, -0.85, -1.55, 0.32, 0.22, 10))
    if name == "camera":
        return _merge(
            _box(-0.06, 0.0, 0.0, 0.12, 0.24, 0.16),
            _cylinder(0.05, 0.0, 0.0, 0.05, 0.10, 10))
    if name == "drone":
        arms = []
        for sx in (-1, 1):
            for sy in (-1, 1):
                arms.append(_box(0.18 * sx, 0.18 * sy, 0.0, 0.24, 0.04, 0.03))
                arms.append(_cylinder(0.3 * sx, 0.3 * sy, 0.03, 0.12, 0.01, 8))
        return _merge(_box(0, 0, 0, 0.22, 0.22, 0.08), *arms)
    # generic spinning-lidar puck
    return _merge(_cylinder(0, 0, 0, 0.06, 0.07, 16),
                  _box(0.05, 0.0, 0.0, 0.02, 0.02, 0.05))


NAMES = ("kitti_car", "ipb_car", "camera", "drone", "lidar")


def write_all(cad_dir: str) -> Dict[str, str]:
    """Write every glyph as <cad_dir>/<name>.ply; returns name -> path."""
    from pin_slam_torch.dataset import io as pio

    os.makedirs(cad_dir, exist_ok=True)
    out = {}
    for name in NAMES:
        v, f = glyph(name)
        path = os.path.join(cad_dir, f"{name}.ply")
        pio.write_ply(path, v, faces=f)
        out[name] = path
    return out


if __name__ == "__main__":
    import sys

    print(write_all(sys.argv[1] if len(sys.argv) > 1 else "cad"))
