"""The LiDAR-scene generator: sequences made on the device from a seed.

A sequence is a scene, a sensor trajectory through it, and the sweeps a
spinning LiDAR takes of the scene along the trajectory.  This general
generator makes every traffic mix that names it (``"generator":
"lidar_scene"``); a mix is a file of parameters
(``slambench/traffic/<name>.json``), a sensor is a block of the
configuration's file (``sensor``).  ``make`` builds it; the harness and
the check use only what ``Generator`` documents as the generator's
interface.

- Scene: a ground plane at z = 0 and axis-aligned boxes (buildings, parked
  cars, poles, trunks, canopies, benches) placed in rows along both sides of
  every segment of the path.  A row places a fixed number of boxes per
  segment (its length over the row's pitch), so every seed has the same
  number of boxes and only their sizes and places differ.
- Trajectory: the path is a polyline of axis-aligned segments with rounded
  corners, open or closed.  The carrier moves along it at a speed that varies
  sinusoidally, weaves across it, and sways in yaw, roll and pitch and bobs
  in height (a handheld sensor), all with seed-drawn phases.  Pose(tau) is
  defined for continuous time tau in frames; frame i's ground truth is the
  pose at tau = i, the middle of its sweep.
- Sweeps: beams at the sensor's elevation angles, columns at equal azimuth
  steps.  Without ``moving_sweep`` a sweep is taken at one instant.  With it,
  each column is fired at its own time, tau = i + s - 0.5, where
  s = (1 - azimuth / pi) / 2 is the time a clockwise sweep from azimuth pi
  reaches it; that is the per-point time ``pin_slam_torch`` recovers from a
  point's azimuth when a frame carries none.  Ranges get Gaussian noise; a
  ray that hits nothing within the sensor's range returns no point.

Everything random is drawn with ``torch.Generator`` on the device, from
sub-seeds of the run's seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from slambench.seeds import torch_gen

F64 = torch.float64
CORNER_PULL = 0.7


def _uniform(gen, lo_hi, n, device):
    lo, hi = float(lo_hi[0]), float(lo_hi[1])
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=F64)


# ----------------------------------------------------------------------
# the path
# ----------------------------------------------------------------------


@dataclass
class Path:
    """A densely sampled polyline: points (n, 2), cumulative arc length (n,),
    the raw segments [(a, b), ...] the scene is built along, and whether it
    closes on itself."""
    xy: torch.Tensor
    s: torch.Tensor
    segments: list
    closed: bool

    @property
    def length(self) -> float:
        return float(self.s[-1])


def make_path(spec: dict, device) -> Path:
    """The path of a traffic mix: ``waypoints`` [[x, y], ...] joined by
    axis-aligned segments, each corner rounded over ``corner_radius_m`` of
    both segments,
    ``closed`` joining the last waypoint back to the first; sampled every
    ``step_m`` (default 0.05 m)."""
    wp = np.asarray(spec["waypoints"], np.float64)
    closed = bool(spec.get("closed", False))
    r = float(spec.get("corner_radius_m", 0.0))
    step = float(spec.get("step_m", 0.05))
    pts = np.concatenate([wp, wp[:1]]) if closed else wp
    segs = [(pts[i], pts[i + 1]) for i in range(len(pts) - 1)]
    for a, b in segs:
        if a[0] != b[0] and a[1] != b[1]:
            raise ValueError(f"segment {a} -> {b} is not axis-aligned")
    out = []
    n = len(segs)
    for i, (a, b) in enumerate(segs):
        d = (b - a) / np.linalg.norm(b - a)
        start_cut = r if (closed or i > 0) else 0.0
        end_cut = r if (closed or i < n - 1) else 0.0
        p0, p1 = a + d * start_cut, b - d * end_cut
        L = np.linalg.norm(p1 - p0)
        m = max(int(math.ceil(L / step)), 1)
        out.append(p0 + (p1 - p0) * (np.arange(m)[:, None] / m))
        if end_cut > 0:
            # quarter arc from this segment's end to the next's start
            nxt = segs[(i + 1) % n]
            d2 = (nxt[1] - nxt[0]) / np.linalg.norm(nxt[1] - nxt[0])
            q0, q1 = b - d * r, b + d2 * r
            na = max(int(math.ceil(0.5 * math.pi * r / step)), 2)
            u = np.arange(na)[:, None] / na
            # cubic Bezier tangent to both segments, its inner control
            # points CORNER_PULL of the way to the corner: the heading's rate
            # starts small where it meets them and peaks mid-turn
            p1, p2 = q0 + CORNER_PULL * r * d, q1 - CORNER_PULL * r * d2
            out.append((1 - u) ** 3 * q0 + 3 * (1 - u) ** 2 * u * p1
                       + 3 * (1 - u) * u ** 2 * p2 + u ** 3 * q1)
    if not closed:
        out.append(segs[-1][1][None, :])
    xy = np.concatenate(out)
    if closed:
        xy = np.concatenate([xy, xy[:1]])
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(xy, axis=0), axis=1))])
    return Path(torch.as_tensor(xy, dtype=F64, device=device),
                torch.as_tensor(s, dtype=F64, device=device), segs, closed)


def path_at(path: Path, s: torch.Tensor):
    """(xy (..., 2), unit tangent (..., 2)) at arc lengths ``s`` (wrapped on a
    closed path, clamped on an open one)."""
    L = path.s[-1]
    s = torch.remainder(s, L) if path.closed else torch.clamp(s, 0.0, float(L))
    j = torch.clamp(torch.searchsorted(path.s, s.reshape(-1).contiguous(), right=True) - 1,
                    0, path.s.shape[0] - 2)
    s0, s1 = path.s[j], path.s[j + 1]
    u = ((s.reshape(-1) - s0) / torch.clamp(s1 - s0, min=1e-12))[:, None]
    a, b = path.xy[j], path.xy[j + 1]
    tan = (b - a) / torch.clamp(torch.linalg.norm(b - a, dim=1, keepdim=True), min=1e-12)
    return (a + u * (b - a)).reshape(*s.shape, 2), tan.reshape(*s.shape, 2)


# ----------------------------------------------------------------------
# the trajectory
# ----------------------------------------------------------------------


class Trajectory:
    """Pose(tau) of the carrier at continuous time tau (frames).

    Speed: ``speed_m_per_frame`` times a ramp from standstill over
    ``ramp_frames`` (half a cosine) times 1 + a sin(2 pi tau / P + phi)
    (``speed_wave`` [a, P]); the arc length is its integral, tabulated every
    ``TAU_STEP`` frames.  ``weave`` [a, P_m] moves the carrier across the
    path by a sin(2 pi s / P_m + phi) along the arc length s and turns its
    heading with the slope; ``yaw_sway_rad``, ``roll_sway_rad``,
    ``pitch_sway_rad`` and ``height_bob_m`` [a, P] are sinusoids in time."""

    TAU_STEP = 0.01

    def __init__(self, spec: dict, path: Path, seed: int, device):
        self.spec, self.path, self.device = spec, path, device
        g = torch_gen(seed, 1, device)
        self.phase = (2 * math.pi * torch.rand(8, generator=g, device=device, dtype=F64)).tolist()
        self.v0 = float(spec["speed_m_per_frame"])
        self._table = None

    def _sin(self, key: str, x: torch.Tensor, slot: int):
        amp, period = self.spec.get(key, [0.0, 1.0])
        return float(amp), float(period), torch.sin(2 * math.pi * x / period + self.phase[slot])

    def speed(self, tau: torch.Tensor) -> torch.Tensor:
        T = float(self.spec.get("ramp_frames", 0.0))
        ramp = (0.5 * (1 - torch.cos(math.pi * torch.clamp(tau / T, max=1.0))) if T > 0
                else torch.ones_like(tau))
        a, _, sin_v = self._sin("speed_wave", tau, 0)
        return self.v0 * ramp * (1 + a * sin_v)

    def arc(self, tau: torch.Tensor) -> torch.Tensor:
        """Arc length at tau (the speed's integral, interpolated in a table
        that grows to cover the times asked for)."""
        need = float(tau.max()) + 2.0 if tau.numel() else 2.0
        if self._table is None or self._table.shape[0] * self.TAU_STEP < need:
            n = int(math.ceil(max(need, 64.0) * 2 / self.TAU_STEP))
            grid = torch.arange(n, device=self.device, dtype=F64) * self.TAU_STEP
            v = self.speed(grid)
            s = torch.cat([v.new_zeros(1), torch.cumsum(0.5 * (v[1:] + v[:-1]), 0)]) \
                * self.TAU_STEP
            self._table = s + float(self.spec.get("start_s_m", 0.0))
        x = torch.clamp(tau, min=0.0) / self.TAU_STEP
        j = torch.clamp(x.floor().long(), max=self._table.shape[0] - 2)
        u = x - j
        return self._table[j] * (1 - u) + self._table[j + 1] * u

    def poses(self, tau: torch.Tensor):
        """(R (..., 3, 3), t (..., 3)) in float64 at times ``tau``."""
        tau = tau.to(F64)
        s = self.arc(tau)
        xy, tan = path_at(self.path, s)
        nrm = torch.stack([-tan[..., 1], tan[..., 0]], -1)        # left of the path
        a_l, p_l, sin_l = self._sin("weave", s, 1)
        xy = xy + (a_l * sin_l)[..., None] * nrm
        slope = a_l * 2 * math.pi / p_l * torch.cos(2 * math.pi * s / p_l + self.phase[1])
        heading = torch.atan2(tan[..., 1], tan[..., 0]) + torch.atan(slope)
        a_y, _, sin_y = self._sin("yaw_sway_rad", tau, 2)
        a_r, _, sin_r = self._sin("roll_sway_rad", tau, 3)
        a_p, _, sin_p = self._sin("pitch_sway_rad", tau, 4)
        a_h, _, sin_h = self._sin("height_bob_m", tau, 5)
        R = _rpy(a_r * sin_r, a_p * sin_p, heading + a_y * sin_y)
        z = float(self.spec["sensor_height_m"]) + a_h * sin_h
        t = torch.stack([xy[..., 0], xy[..., 1], z], -1)
        return R, t

    def frame_poses(self, n: int) -> np.ndarray:
        """Ground truth of frames 0..n-1 (the pose at mid-sweep), (n, 4, 4)
        float64 on the host."""
        R, t = self.poses(torch.arange(n, device=self.device, dtype=F64))
        T = torch.zeros((n, 4, 4), dtype=F64, device=self.device)
        T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, t, 1.0
        return T.cpu().numpy()


def _rpy(roll, pitch, yaw):
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


# ----------------------------------------------------------------------
# the scene
# ----------------------------------------------------------------------


@dataclass
class Scene:
    lo: torch.Tensor     # (K, 3) box corners, float64
    hi: torch.Tensor     # (K, 3)


def make_scene(spec: dict, path: Path, seed: int, device) -> Scene:
    """Boxes in ``rows`` along both sides of every path segment.  A row is
    {"side": "left"|"right"|"both", "pitch_m", "fill": [lo, hi] (the share
    of the pitch a box takes along the segment), "offset_m": [lo, hi] (from
    the path to the box's near face), "depth_m", "height_m", "z0_m"
    (default 0), "end_margin_m" (kept free at both ends of a segment,
    default 0)}."""
    g = torch_gen(seed, 2, device)
    los, his = [], []
    for a, b in path.segments:
        a = torch.as_tensor(a, dtype=F64, device=device)
        b = torch.as_tensor(b, dtype=F64, device=device)
        seg_len = float(torch.linalg.norm(b - a))
        d = (b - a) / seg_len
        left = torch.stack([-d[1], d[0]])
        for row in spec["rows"]:
            sides = {"left": [1.0], "right": [-1.0], "both": [1.0, -1.0]}[row["side"]]
            margin = float(row.get("end_margin_m", 0.0))
            usable = seg_len - 2 * margin
            pitch = float(row["pitch_m"])
            n = int(usable // pitch)
            if n <= 0:
                continue
            for sgn in sides:
                fill = _uniform(g, row["fill"], n, device) * pitch
                start = (margin + pitch * torch.arange(n, device=device, dtype=F64)
                         + (pitch - fill) * torch.rand(n, generator=g, device=device,
                                                       dtype=F64))
                off = _uniform(g, row["offset_m"], n, device)
                depth = _uniform(g, row["depth_m"], n, device)
                height = _uniform(g, row["height_m"], n, device)
                z0 = float(row.get("z0_m", 0.0))
                p0 = a + start[:, None] * d + (sgn * off)[:, None] * left
                p1 = (a + (start + fill)[:, None] * d
                      + (sgn * (off + depth))[:, None] * left)
                lo2, hi2 = torch.minimum(p0, p1), torch.maximum(p0, p1)
                los.append(torch.cat([lo2, torch.full((n, 1), z0, dtype=F64, device=device)],
                                     1))
                his.append(torch.cat([hi2, (z0 + height)[:, None]], 1))
    return Scene(torch.cat(los), torch.cat(his))


def scene_sdf(scene: Scene, q: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Signed distance (float64) from points ``q`` (m, 3) to the scene: the
    ground plane z = 0 and the union of the boxes."""
    out = []
    lo, hi = scene.lo.to(q.device), scene.hi.to(q.device)
    for c in range(0, q.shape[0], chunk):
        p = q[c:c + chunk].to(F64)
        d = torch.maximum(lo[None] - p[:, None], p[:, None] - hi[None])      # (m, K, 3)
        outside = torch.linalg.norm(torch.clamp(d, min=0.0), dim=-1)
        inside = torch.clamp(torch.amax(d, dim=-1), max=0.0)
        box = torch.amin(outside + inside, dim=1)
        out.append(torch.minimum(box, p[:, 2]))
    return torch.cat(out) if out else q.new_zeros((0,), dtype=F64)


# ----------------------------------------------------------------------
# the sensor
# ----------------------------------------------------------------------


def beam_elevations(sensor: dict) -> np.ndarray:
    """Elevation angles (radians) of the sensor's beams, top first: each of
    ``blocks`` [[top_deg, bottom_deg, count], ...] spaced evenly."""
    els = [np.linspace(top, bot, int(n)) for top, bot, n in sensor["blocks"]]
    return np.radians(np.concatenate(els))


def sensor_rays(sensor: dict, device):
    """(unit directions (C, B, 3) in the sensor frame, column times s (C,))
    for C columns and B beams, in firing order (column by column)."""
    el = torch.as_tensor(beam_elevations(sensor), dtype=F64, device=device)
    C = int(sensor["columns"])
    # clockwise from azimuth pi: s = (1 - az / pi) / 2 in [0, 1)
    s = (torch.arange(C, device=device, dtype=F64) + 0.5) / C
    az = math.pi * (1.0 - 2.0 * s)
    ce = torch.cos(el)
    d = torch.stack([torch.cos(az)[:, None] * ce[None], torch.sin(az)[:, None] * ce[None],
                     torch.sin(el)[None].expand(C, -1)], -1)
    return d, s


def cast(scene_lo, scene_hi, o, d, max_range: float, chunk: int = 1 << 16):
    """Range (float64) of each ray (origin o (n, 3), unit direction d (n, 3))
    to the first box face or the ground, +inf where nothing lies within
    ``max_range``: every ray against every box (the tests' yardstick for
    ``cast_columns``)."""
    out = []
    for c in range(0, o.shape[0], chunk):
        oc, dc = o[c:c + chunk], d[c:c + chunk]
        t_box = _slab(scene_lo[None], scene_hi[None], oc[:, None], dc[:, None]) \
            if scene_lo.shape[0] else torch.full_like(oc[:, 0], math.inf)
        out.append(_nearest(t_box, oc[:, None], dc[:, None], max_range))
    return torch.cat(out)


def _slab(lo, hi, o, d):
    """The entry distance of rays (o, d) (..., 1, 3) into boxes (lo, hi)
    (..., K, 3), the nearest over the boxes; +inf where none is hit."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= tmin) & (tmin > 0.0)
    return torch.amin(torch.where(hit, tmin, torch.full_like(tmin, math.inf)), dim=-1)


def _nearest(t_box, o, d, max_range):
    oz, dz = o[..., 0, 2], d[..., 0, 2]
    t_gnd = torch.where(dz < -1e-9, -oz / dz, torch.full_like(oz, math.inf))
    t = torch.minimum(t_box, t_gnd)
    return torch.where(t <= max_range, t, torch.full_like(t, math.inf))


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def column_boxes(lo, hi, o_col, d_col):
    """(C, Kc) indices of the boxes the rays of each column may hit, -1
    padded: those whose footprint's azimuth interval, seen from the column's
    origin (o_col (C, 3), or (1, 3) for all), meets the azimuths of the
    column's rays, and those whose footprint holds the origin."""
    ox, oy = o_col[:, None, 0], o_col[:, None, 1]                      # (C, 1)
    cx = torch.stack([lo[:, 0], hi[:, 0], hi[:, 0], lo[:, 0]], 1)        # (K, 4)
    cy = torch.stack([lo[:, 1], lo[:, 1], hi[:, 1], hi[:, 1]], 1)
    mid = 0.5 * (lo + hi)
    a_mid = torch.atan2(mid[None, :, 1] - oy, mid[None, :, 0] - ox)     # (C, K)
    rel = _wrap(torch.atan2(cy[None] - oy[..., None], cx[None] - ox[..., None])
                - a_mid[..., None])                                     # (C, K, 4)
    a_ray = torch.atan2(d_col[..., 1], d_col[..., 0])                   # (C, B)
    dev = _wrap(a_ray - a_ray[:, :1])
    half = 0.5 * (dev.amax(1) - dev.amin(1))[:, None] + 1e-6
    a_c = a_ray[:, :1] + 0.5 * (dev.amax(1) + dev.amin(1))[:, None]
    rc = _wrap(a_c - a_mid)
    inside = ((ox >= lo[None, :, 0]) & (ox <= hi[None, :, 0])
              & (oy >= lo[None, :, 1]) & (oy <= hi[None, :, 1]))
    mask = inside | ((rc >= rel.amin(-1) - half) & (rc <= rel.amax(-1) + half))
    kc = max(int(mask.sum(1).max()), 1)
    score, idx = torch.topk(mask.to(torch.int8), kc, dim=1)
    return torch.where(score > 0, idx, torch.full_like(idx, -1))


def cast_columns(lo, hi, o_col, d, max_range: float, budget: int = 1 << 25):
    """Ranges (float64) of a sweep's rays, d (C, B, 3) from the column
    origins o_col (C, 3) (or one origin (1, 3) for the sweep), each column
    tested against ``column_boxes`` alone, in float32 about the sweep's
    first origin; +inf where nothing lies within ``max_range``."""
    C, B = d.shape[:2]
    ref = o_col[0]
    lo32 = torch.cat([(lo - ref).float(), lo.new_full((1, 3), 1e9).float()])
    hi32 = torch.cat([(hi - ref).float(), hi.new_full((1, 3), 1e9).float()])
    o32, d32 = (o_col - ref).float(), d.float()
    idx = column_boxes(lo, hi, o_col, d)
    idx = torch.where(idx < 0, torch.full_like(idx, lo.shape[0]), idx)
    kc = idx.shape[1]
    step = max(1, budget // max(B * kc * 3, 1))
    out = []
    for c in range(0, C, step):
        j = idx[c:c + step]
        oc = (o32[c:c + step] if o32.shape[0] > 1 else o32).expand(j.shape[0], 3)
        oc = oc[:, None, None, :].expand(-1, B, 1, 3)
        dc = d32[c:c + step, :, None, :]
        t_box = _slab(lo32[j][:, None], hi32[j][:, None], oc, dc)
        oz = oc + ref.float() * torch.tensor([0.0, 0.0, 1.0], device=d.device)
        out.append(_nearest(t_box, oz, dc, max_range))
    return torch.cat(out).reshape(-1).to(F64)


@dataclass
class Sequence:
    """A generated sequence: sweeps (host float32 arrays in the sensor frame,
    one per frame) and ground truth (n, 4, 4) float64, with what made them."""
    scans: List[np.ndarray]
    gt_poses: np.ndarray
    scene: Scene
    traj: Trajectory
    sensor: dict
    seed: int


def make(sensor: dict, traffic: dict, seed: int, device) -> "Generator":
    """The generator of one run (every generator module has ``make``)."""
    return Generator(sensor, traffic, seed, device)


class Generator:
    """The sequence of one cell: ``sensor`` from the configuration's file,
    ``traffic`` from the traffic mix's file, ``seed`` the run's.

    The interface the harness and the check use, which every generator
    module's ``make`` returns: ``sequence(n)`` (``scans``, ``gt_poses``),
    ``max_frames()``, ``frame_poses(n)`` and ``pose(i)`` (ground truth),
    ``hits(i, noise)`` (frame i's returns) and ``truth_sdf(points)`` (the
    scene's exact signed distance), with ``device``."""

    def __init__(self, sensor: dict, traffic: dict, seed: int, device):
        self.sensor, self.traffic, self.seed, self.device = sensor, traffic, seed, device
        # a mix with a ``scene_seed`` names its scene and its motion's
        # phases, as a recorded sequence does; the run's seed then draws the
        # sensor's noise (and seeds the system)
        layout = int(traffic.get("scene_seed", seed))
        self.path = make_path(traffic["path"], device)
        self.traj = Trajectory({**traffic["motion"],
                                "sensor_height_m": sensor["height_m"]}, self.path, layout, device)
        self.scene = make_scene(traffic["scene"], self.path, layout, device)
        self.dirs, self.col_s = sensor_rays(sensor, device)

    def max_frames(self) -> Optional[int]:
        """Frames before the carrier reaches the end of an open path (None
        on a closed one)."""
        return max_frames_on_path(self.traffic)

    def frame_poses(self, n: int) -> np.ndarray:
        """Ground truth of frames 0..n-1, (n, 4, 4) float64 on the host."""
        return self.traj.frame_poses(n)

    def pose(self, i: int) -> np.ndarray:
        """Ground truth of frame i, (4, 4) float64 on the host."""
        R, t = self.traj.poses(torch.tensor([float(i)], dtype=F64, device=self.device))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R[0].cpu().numpy(), t[0].cpu().numpy()
        return T

    def truth_sdf(self, q: torch.Tensor) -> torch.Tensor:
        """The scene's exact signed distance at world points ``q`` (m, 3)."""
        return scene_sdf(self.scene, q)

    def _poses(self, frames: torch.Tensor):
        """The sensor's poses at the columns of ``frames`` (F,): (R (F, C', 3,
        3), t (F, C', 3)), C' the columns with a moving sweep, else 1 (one
        instant a sweep)."""
        frames = frames.to(F64)
        if self.sensor.get("moving_sweep", False):
            tau = frames[:, None] + self.col_s[None, :] - 0.5
        else:
            tau = frames[:, None]
        return self.traj.poses(tau)

    def _frame_rays(self, i: int, pose=None):
        """(column origins (C', 3), world directions (C, B, 3)) of frame i;
        ``pose`` is its row of ``_poses`` where the caller has it."""
        R, t = pose if pose is not None else [p[0] for p in self._poses(
            torch.tensor([float(i)], device=self.device))]
        C = self.dirs.shape[0]
        return t, torch.einsum("cij,cbj->cbi", R.expand(C, 3, 3), self.dirs)

    def _boxes_near(self, origin: torch.Tensor, reach: float):
        c = 0.5 * (self.scene.lo + self.scene.hi)
        half = 0.5 * torch.linalg.norm(self.scene.hi - self.scene.lo, dim=1)
        near = torch.linalg.norm(c[:, :2] - origin[None, :2], dim=1) - half < reach
        return self.scene.lo[near], self.scene.hi[near]

    def hits(self, i: int, noise: bool, pose=None):
        """Frame i's returns: (sensor-frame points (n, 3), world hit points
        without noise (n, 3), world ray directions (n, 3)), float64."""
        o_col, d_col = self._frame_rays(i, pose)
        rmax = float(self.sensor["max_range_m"])
        lo, hi = self._boxes_near(o_col[0], rmax + 1.0)
        r = cast_columns(lo, hi, o_col, d_col, rmax)
        C, B = d_col.shape[:2]
        o = o_col[:, None, :].expand(C, B, 3).reshape(-1, 3)
        d_w, d_s = d_col.reshape(-1, 3), self.dirs.reshape(-1, 3)
        keep = torch.isfinite(r) & (r >= float(self.sensor["min_range_m"]))
        r, o, d_w, d_s = r[keep], o[keep], d_w[keep], d_s[keep]
        world = o + r[:, None] * d_w
        if noise:
            g = torch_gen(self.seed, 1000 + i, self.device)
            r = r + float(self.sensor["range_noise_m"]) * torch.randn(
                r.shape, generator=g, device=self.device, dtype=F64)
        return d_s * r[:, None], world, d_w

    def sequence(self, n_frames: int, batch: int = 64) -> Sequence:
        """``n_frames`` noisy sweeps, made on the device (poses a batch of
        frames at a time) and copied to the host in one transfer."""
        pts, counts = [], []
        for b0 in range(0, n_frames, batch):
            frames = torch.arange(b0, min(b0 + batch, n_frames), device=self.device)
            R, t = self._poses(frames)
            for j, i in enumerate(frames.tolist()):
                p = self.hits(i, noise=True, pose=(R[j], t[j]))[0].to(torch.float32)
                pts.append(p)
                counts.append(p.shape[0])
        flat = torch.cat(pts).cpu().numpy()
        scans = np.split(flat, np.cumsum(counts)[:-1])
        return Sequence(scans, self.traj.frame_poses(n_frames), self.scene, self.traj,
                        self.sensor, self.seed)


def max_frames_on_path(traffic: dict) -> Optional[int]:
    """On an open path, the frames the carrier takes to reach its end (None
    on a closed one)."""
    if traffic["path"].get("closed", False):
        return None
    wp = np.asarray(traffic["path"]["waypoints"], np.float64)
    length = float(np.sum(np.linalg.norm(np.diff(wp, axis=0), axis=1)))
    m = traffic["motion"]
    amp = m.get("speed_wave", [0.0, 1.0])[0]
    return int((length - float(m.get("start_s_m", 0.0))) / (m["speed_m_per_frame"] * (1 + amp))
               + float(m.get("ramp_frames", 0.0)) / 2)
