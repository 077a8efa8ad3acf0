"""The LiDAR-scene generator with each point's time: ``lidar_scene``'s
sequences, whose sweeps carry five columns, x, y, z, intensity and time, as
a recorded rolling sweep (Newer College's PLY frames, their ``t`` field)
carries them.

The scene, the trajectory, the rays and the ranges are
``lidar_scene.Generator``'s, drawn from the same seeds, so the points are
its points bit for bit.  A point's time is the time its column fired,
``col_s`` of ``lidar_scene.sensor_rays`` (in [0, 1) over the sweep; with
``moving_sweep`` the column's pose is the trajectory's at frame i +
time - 0.5), kept through the same mask as the points.  The intensity
column is 0: the generator models no reflectance, and a profile without
``color_on`` reads none.

The interface is ``lidar_scene``'s (``make``, and the ``Generator``'s
``sequence``, ``max_frames``, ``frame_poses``, ``pose``, ``hits``,
``truth_sdf``, ``device``); ``hits_timed(i, noise)`` adds the times to
``hits``.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.generators import lidar_scene as base
from slambench.seeds import torch_gen

F64 = base.F64


def make(sensor: dict, traffic: dict, seed: int, device) -> "Generator":
    """The generator of one run (every generator module has ``make``)."""
    return Generator(sensor, traffic, seed, device)


class Generator(base.Generator):
    """``lidar_scene.Generator`` whose sequences hand each point's time."""

    def hits_timed(self, i: int, noise: bool, pose=None):
        """``hits(i, noise, pose)`` and the time (n,) float64 each returned
        point's column fired."""
        o_col, d_col = self._frame_rays(i, pose)
        rmax = float(self.sensor["max_range_m"])
        lo, hi = self._boxes_near(o_col[0], rmax + 1.0)
        r = base.cast_columns(lo, hi, o_col, d_col, rmax)
        C, B = d_col.shape[:2]
        o = o_col[:, None, :].expand(C, B, 3).reshape(-1, 3)
        d_w, d_s = d_col.reshape(-1, 3), self.dirs.reshape(-1, 3)
        s = self.col_s[:, None].expand(C, B).reshape(-1)
        keep = torch.isfinite(r) & (r >= float(self.sensor["min_range_m"]))
        r, o, d_w, d_s, s = r[keep], o[keep], d_w[keep], d_s[keep], s[keep]
        world = o + r[:, None] * d_w
        if noise:
            g = torch_gen(self.seed, 1000 + i, self.device)
            r = r + float(self.sensor["range_noise_m"]) * torch.randn(
                r.shape, generator=g, device=self.device, dtype=F64)
        return d_s * r[:, None], world, d_w, s

    def hits(self, i: int, noise: bool, pose=None):
        return self.hits_timed(i, noise, pose)[:3]

    def sequence(self, n_frames: int, batch: int = 64) -> base.Sequence:
        """``n_frames`` noisy sweeps of five columns (x, y, z, intensity 0,
        time), made on the device and copied to the host in one transfer."""
        rows, counts = [], []
        for b0 in range(0, n_frames, batch):
            frames = torch.arange(b0, min(b0 + batch, n_frames), device=self.device)
            R, t = self._poses(frames)
            for j, i in enumerate(frames.tolist()):
                p, _, _, s = self.hits_timed(i, noise=True, pose=(R[j], t[j]))
                rows.append(torch.cat([p, torch.zeros_like(s)[:, None], s[:, None]], 1)
                            .to(torch.float32))
                counts.append(p.shape[0])
        flat = torch.cat(rows).cpu().numpy()
        scans = np.split(flat, np.cumsum(counts)[:-1])
        return base.Sequence(scans, self.traj.frame_poses(n_frames), self.scene, self.traj,
                             self.sensor, self.seed)
