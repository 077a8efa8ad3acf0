"""Loop closure detection, torch counterpart of
``pin_slam_tpu/slam/loop_detector.py``: scan-context descriptors of the local
neural point map, ring keys, yaw-aligned cosine distances, the descriptor
history with global (scan-context) detection, local (pose-distance)
detection, and the ground-truth loop oracle used for debugging.

* Descriptor: a 20 x 60 polar (ring x sector) max-height grid of the local
  map in the sensor frame (one ``scatter_reduce(amax)``), optionally a per-bin
  mean of the neural point features.
* Ring key: per-ring mean, for a cheap L1 prefilter.
* Global search: ring-key prefilter, then the column-wise cosine distance
  minimised over all 60 column rolls at once.
* Lateral virtual nodes: descriptors also built at +-lateral offsets.

Descriptors are built on the map's device without a host round trip
(``add_node_device``) and fetched at the next detection
(``materialize_pending``); the matching itself runs on the host.

Bins follow the JAX package's rounding (``div_f32`` for divisions by a
constant, as XLA compiles them); a point within an ulp of a bin edge may
still land in the neighbouring bin, since ``atan2``/``sqrt`` may differ by
an ulp between the two libraries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from pin_slam_torch.ops.hash3d import div_f32


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    num_rings: int = 20
    num_sectors: int = 60
    max_radius: float = 80.0
    cosdist_threshold: float = 0.2
    num_candidates: int = 1
    virtual_side_count: int = 4
    virtual_step: float = 2.0          # m lateral shift per virtual node
    min_travel_dist_ratio: float = 4.0
    local_map_radius: float = 62.0
    max_loop_dist: float = 8.0
    z_check_on: bool = False
    with_feature: bool = False         # per-bin mean neural-point features

    @staticmethod
    def from_config(cfg) -> "LoopConfig":
        return LoopConfig(
            num_rings=cfg.context_shape[0], num_sectors=cfg.context_shape[1],
            max_radius=cfg.max_range, cosdist_threshold=cfg.context_cosdist_threshold,
            num_candidates=cfg.context_num_candidates,
            virtual_side_count=cfg.context_virtual_side_count,
            min_travel_dist_ratio=cfg.min_loop_travel_dist_ratio,
            local_map_radius=cfg.local_map_radius, max_loop_dist=cfg.max_loop_dist,
            z_check_on=cfg.loop_z_check_on, with_feature=cfg.loop_with_feature)


def _bins(points: torch.Tensor, valid: torch.Tensor, num_rings: int, num_sectors: int,
          max_radius: float):
    """Flat (ring, sector) bin of every point (num_rings*num_sectors for the
    invalid and out-of-range ones) and the in-range mask."""
    x, y = points[:, 0], points[:, 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) + math.pi
    ring = torch.clamp((div_f32(r, max_radius) * num_rings).to(torch.int64),
                       max=num_rings - 1)
    sector = torch.clamp((div_f32(theta, 2 * math.pi) * num_sectors).to(torch.int64),
                         max=num_sectors - 1)
    ok = valid & (r < max_radius)
    flat = torch.where(ok, ring * num_sectors + sector,
                       torch.full_like(ring, num_rings * num_sectors))
    return flat, ok


def scan_context(points: torch.Tensor, valid: torch.Tensor, num_rings: int = 20,
                 num_sectors: int = 60, max_radius: float = 80.0) -> torch.Tensor:
    """Polar max-height descriptor (num_rings, num_sectors): per bin the
    largest z + 2 m, 0 for empty bins.  points (N,3) in the sensor frame."""
    flat, ok = _bins(points, valid, num_rings, num_sectors, max_radius)
    z = torch.where(ok, points[:, 2] + 2.0, torch.zeros_like(points[:, 2]))
    desc = torch.zeros((num_rings * num_sectors + 1,), dtype=torch.float32,
                       device=points.device)
    desc = desc.scatter_reduce(0, flat, z, reduce="amax", include_self=True)
    return torch.clamp(desc[:-1].reshape(num_rings, num_sectors), min=0.0)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row means."""
    return torch.mean(desc, dim=-1)


def scan_context_feature(points: torch.Tensor, features: torch.Tensor, valid: torch.Tensor,
                         num_rings: int = 20, num_sectors: int = 60,
                         max_radius: float = 80.0) -> torch.Tensor:
    """Per-bin mean of the neural point features, (num_rings, num_sectors, F);
    empty bins are zero."""
    flat, ok = _bins(points, valid, num_rings, num_sectors, max_radius)
    nb = num_rings * num_sectors + 1
    F = features.shape[1]
    acc = torch.zeros((nb, F), dtype=torch.float32, device=points.device)
    acc.index_add_(0, flat, torch.where(ok[:, None], features, torch.zeros_like(features)))
    cnt = torch.zeros((nb,), dtype=torch.float32, device=points.device)
    cnt.index_add_(0, flat, ok.to(torch.float32))
    mean = acc / torch.clamp(cnt, min=1.0)[:, None]
    return mean[:-1].reshape(num_rings, num_sectors, F)


def _rolled(query: torch.Tensor) -> torch.Tensor:
    """All column rolls of a (R, S, ...) descriptor: (S_roll, R, S, ...)."""
    S = query.shape[1]
    ar = torch.arange(S, device=query.device)
    idx = (ar[None, :] + ar[:, None]) % S
    return torch.movedim(query[:, idx], 1, 0)


def sc_distance_with_yaw(query: torch.Tensor, candidates: torch.Tensor):
    """Min cosine distance over all column rolls, for each candidate:
    column-wise cosine similarity averaged over the candidate's non-empty
    columns.  query (R,S); candidates (M,R,S).  Returns (dist (M,),
    yaw_shift (M,))."""
    q_rolled = _rolled(query)                                       # (S_roll, R, S)
    qn = q_rolled / (torch.linalg.norm(q_rolled, dim=1, keepdim=True) + 1e-9)
    cn = candidates / (torch.linalg.norm(candidates, dim=1, keepdim=True) + 1e-9)
    sim = torch.einsum("mrs,krs->mks", cn, qn)                      # (M, S_roll, S)
    nonzero = (torch.linalg.norm(candidates, dim=1) > 1e-6).to(torch.float32)
    denom = torch.clamp(torch.sum(nonzero, dim=-1), min=1.0)
    mean_sim = torch.sum(sim * nonzero[:, None, :], dim=-1) / denom[:, None]
    return 1.0 - torch.amax(mean_sim, dim=-1), torch.argmax(mean_sim, dim=-1)


def sc_feature_distance_with_yaw(query: torch.Tensor, candidates: torch.Tensor):
    """Feature-descriptor distance with yaw alignment: per-(sector, channel)
    cosine similarity over the ring dimension, averaged over all columns.
    query (R,S,F); candidates (M,R,S,F).  Returns (dist (M,), yaw_shift (M,))."""
    R, S, F = query.shape
    q_rolled = _rolled(query)                                       # (S_roll, R, S, F)
    qn = q_rolled / (torch.linalg.norm(q_rolled, dim=1, keepdim=True) + 1e-9)
    cn = candidates / (torch.linalg.norm(candidates, dim=1, keepdim=True) + 1e-9)
    sim = torch.einsum("mrsf,krsf->mk", cn, qn) / (S * F)
    return 1.0 - torch.amax(sim, dim=-1), torch.argmax(sim, dim=-1)


def _descriptors(local: torch.Tensor, valid: torch.Tensor, offsets: Tuple[float, ...],
                 num_rings: int, num_sectors: int, max_radius: float,
                 features: Optional[torch.Tensor]):
    descs, fdescs = [], []
    for off in offsets:
        shifted = local.clone()
        shifted[:, 1] += off
        descs.append(scan_context(shifted, valid, num_rings, num_sectors, max_radius))
        if features is not None:
            fdescs.append(scan_context_feature(shifted, features, valid, num_rings,
                                               num_sectors, max_radius))
    descs = torch.stack(descs)
    rks = torch.mean(descs, dim=-1)
    if features is not None:
        fdescs = torch.stack(fdescs)
        return descs, rks, fdescs, torch.mean(fdescs, dim=2)
    return descs, rks


def build_node_descriptors(positions: torch.Tensor, count: torch.Tensor,
                           R_w: torch.Tensor, t_w: torch.Tensor,
                           offsets: Tuple[float, ...], num_rings: int, num_sectors: int,
                           max_radius: float, features: Optional[torch.Tensor] = None,
                           with_feature: bool = False):
    """One frame's descriptors at every lateral virtual offset, on the map's
    device.  positions (L+1,3) world frame; count (); R_w/t_w the frame pose
    (world <- sensor).  Returns (descs (V,R,S), ring_keys (V,R)[, feat_descs
    (V,R,S,F), feat_ring_keys (V,R,F)])."""
    local = (positions - t_w) @ R_w
    valid = torch.arange(positions.shape[0], device=positions.device) < count
    return _descriptors(local, valid, offsets, num_rings, num_sectors, max_radius,
                        features if with_feature else None)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class NeuralPointMapContextManager:
    """History of descriptors + global loop detection."""

    def __init__(self, lc: LoopConfig):
        self.lc = lc
        self.descriptors: List[np.ndarray] = []       # per frame (V, R, S)
        self.ring_keys: List[np.ndarray] = []         # (V, R)
        self.feat_descriptors: List[np.ndarray] = []  # (V, R, S, F) when with_feature
        self.feat_ring_keys: List[np.ndarray] = []    # (V, R, F)
        self.frame_ids: List[int] = []
        self._pending: List[tuple] = []               # (frame_id, device tensors)

    def lateral_offsets(self) -> Tuple[float, ...]:
        offs = [0.0]
        for k in range(1, self.lc.virtual_side_count // 2 + 1):
            offs += [k * self.lc.virtual_step, -k * self.lc.virtual_step]
        return tuple(offs)

    def add_node_device(self, frame_id: int, positions, count, R_w, t_w,
                        features=None) -> None:
        """Build the frame's descriptors on the map's device and queue them;
        they reach the host at the next ``materialize_pending``."""
        dev = positions.device
        out = build_node_descriptors(
            positions, count, torch.as_tensor(R_w, dtype=torch.float32, device=dev),
            torch.as_tensor(t_w, dtype=torch.float32, device=dev), self.lateral_offsets(),
            self.lc.num_rings, self.lc.num_sectors, self.lc.max_radius, features=features,
            with_feature=self.lc.with_feature and features is not None)
        self._pending.append((frame_id, out))

    def drop_pending(self, frame_id: int) -> None:
        """Forget a queued node (lose-track frames never become candidates)."""
        self._pending = [(f, h) for f, h in self._pending if f != frame_id]

    def materialize_pending(self) -> None:
        for frame_id, out in self._pending:
            self.descriptors.append(_np(out[0]))
            self.ring_keys.append(_np(out[1]))
            if len(out) == 4:
                self.feat_descriptors.append(_np(out[2]))
                self.feat_ring_keys.append(_np(out[3]))
            self.frame_ids.append(frame_id)
        self._pending = []

    def detect_global_loop(self, cur_drift: float, travel_dist: List[float],
                           cur_frame: int, k_prefilter: int = 10,
                           poses: Optional[np.ndarray] = None
                           ) -> Tuple[int, float, float]:
        """(loop_frame_id, cos_dist, yaw_rad), or (-1, inf, 0).  With
        ``poses``, candidates are past poses within 3x the estimated drift of
        the current pose."""
        self.materialize_pending()
        lc = self.lc
        if len(self.descriptors) < 2:
            return -1, np.inf, 0.0
        min_travel = lc.min_travel_dist_ratio * lc.local_map_radius
        dist_thre = 3.0 * cur_drift
        cands = []
        for idx in range(len(self.descriptors) - 1):
            fid = self.frame_ids[idx]
            if travel_dist[cur_frame] - travel_dist[fid] < min_travel:
                continue
            if poses is not None and np.linalg.norm(
                    poses[fid][:3, 3] - poses[cur_frame][:3, 3]) > dist_thre:
                continue
            cands.append(idx)
        if not cands:
            return -1, np.inf, 0.0

        use_feat = lc.with_feature and len(self.feat_descriptors) == len(self.descriptors)
        if use_feat:
            rk_all = np.concatenate([self.feat_ring_keys[i].reshape(
                self.feat_ring_keys[i].shape[0], -1) for i in cands])
            cur_key = self.feat_ring_keys[-1][0].reshape(-1)
        else:
            rk_all = np.concatenate([self.ring_keys[i] for i in cands])
            cur_key = self.ring_keys[-1][0]
        owner = np.concatenate([[i] * self.ring_keys[i].shape[0] for i in cands])
        l1 = np.abs(rk_all - cur_key[None]).sum(axis=1)
        top = np.argsort(l1)[:k_prefilter]

        if use_feat:
            sel = np.concatenate([self.feat_descriptors[i] for i in cands])[top]
            dist, shift = sc_feature_distance_with_yaw(
                torch.as_tensor(self.feat_descriptors[-1][0]), torch.as_tensor(sel))
        else:
            sel = np.concatenate([self.descriptors[i] for i in cands])[top]
            dist, shift = sc_distance_with_yaw(torch.as_tensor(self.descriptors[-1][0]),
                                               torch.as_tensor(sel))
        dist, shift = dist.numpy(), shift.numpy()
        best = int(np.argmin(dist))
        if dist[best] > lc.cosdist_threshold:
            return -1, float(dist[best]), 0.0
        yaw = 2 * np.pi * float(shift[best]) / lc.num_sectors
        if yaw > np.pi:
            yaw -= 2 * np.pi
        return self.frame_ids[int(owner[top[best]])], float(dist[best]), yaw


class GTLoopManager:
    """Ground-truth loop oracle, for debugging only."""

    EXCLUDE_RECENT = 30

    def __init__(self, max_loop_dist: float, min_travel_dist_ratio: float = 2.5):
        self.max_loop_dist = max_loop_dist
        self.min_travel_dist_ratio = min_travel_dist_ratio
        self.gt_poses: List[np.ndarray] = []
        self.travel_dist: List[float] = []

    def add_node(self, frame_id: int, gt_pose: np.ndarray) -> None:
        assert frame_id == len(self.gt_poses), "nodes must be added in order"
        self.gt_poses.append(np.asarray(gt_pose, np.float64))
        if frame_id == 0:
            self.travel_dist.append(0.0)
        else:
            step = float(np.linalg.norm(gt_pose[:3, 3] - self.gt_poses[-2][:3, 3]))
            self.travel_dist.append(self.travel_dist[-1] + step)

    def detect_loop(self) -> Tuple[int, float, Optional[np.ndarray]]:
        """(loop_frame_id, distance, T_loop<-cur) or (-1, inf, None)."""
        cur = len(self.gt_poses) - 1
        recent_cut = cur - self.EXCLUDE_RECENT
        if recent_cut <= 0:
            return -1, np.inf, None
        past = np.stack(self.gt_poses[:recent_cut])
        d = np.linalg.norm(past[:, :3, 3] - self.gt_poses[cur][:3, 3], axis=1)
        td = self.travel_dist[cur] - np.asarray(self.travel_dist[:recent_cut])
        cand = (td > self.min_travel_dist_ratio * d) & (td > 30.0)
        if not cand.any():
            return -1, np.inf, None
        idx = np.where(cand)[0]
        best = idx[np.argmin(d[idx])]
        if d[best] >= self.max_loop_dist:
            return -1, np.inf, None
        return int(best), float(d[best]), np.linalg.inv(self.gt_poses[best]) @ self.gt_poses[cur]


def detect_local_loop(pgo_poses: np.ndarray, travel_dist: List[float], cur_frame: int,
                      drift_radius: float, min_travel_ratio: float,
                      local_map_radius: float, max_loop_dist: float,
                      loop_candidate_mask: Optional[np.ndarray] = None,
                      dist_floor: float = 1.0,
                      accept_divisor: float = 1.0) -> Tuple[int, float]:
    """Nearest past pose within the drift radius: (loop_frame_id, distance)
    or (-1, inf).  ``accept_divisor`` tightens the acceptance distance after
    repeated verification failures without shrinking the searchable past."""
    if cur_frame < 2:
        return -1, np.inf
    cur_xyz = pgo_poses[cur_frame][:3, 3]
    min_travel = min_travel_ratio * local_map_radius
    best, best_d = -1, np.inf
    for fid in range(cur_frame - 1):
        if travel_dist[cur_frame] - travel_dist[fid] < min_travel:
            break
        if loop_candidate_mask is not None and not loop_candidate_mask[fid]:
            continue
        d = float(np.linalg.norm(pgo_poses[fid][:3, 3] - cur_xyz))
        if d < best_d:
            best, best_d = fid, d
    thresh = max(drift_radius, dist_floor) / max(accept_divisor, 1.0)
    if best_d < min(thresh, max_loop_dist):
        return best, best_d
    return -1, np.inf
