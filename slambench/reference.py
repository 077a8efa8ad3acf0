"""The plain reference that decides ``correct``: plain PyTorch and NumPy that
imports nothing of ``pin_slam_torch`` (nor JAX).

What the program produces and is judged on:

- its pose books, one pose per frame (pose-graph poses where PGO is on);
- its map: the neural points' positions, quaternions and features, and the
  SDF decoder's weights, as they stand after the last frame.

The reference judges them against the generator's ground truth, which it
works out again from the seed: each frame's true pose, and the scene's exact
signed distance (the generator's ``pose`` and ``truth_sdf``).  It reads the map only to judge
it: its own exact-kNN, inverse-distance-weighted decode of the map at query
points (``map_sdf``), the published form of PIN-SLAM's SDF query, computed
in float64.

The queries: frames sampled from the seed among those the run processed,
and rays sampled from each frame's noise-free returns within the range the
configuration maps.  Each query lies on its ray at a seed-drawn offset
``delta`` from the true surface point x (toward the sensor for delta > 0).
Its true SDF is the scene's at x - delta d; the map is queried at that point
carried into the run's own frame by the frame's estimated pose,
E_i G_i^-1 (x - delta d), so that drift of the trajectory is not charged
to the map.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

F64 = torch.float64
NO_NEIGHBOUR_ERR_M = 1.0     # a query with no map point in reach counts as this error


@dataclass
class MapSnapshot:
    """The program's map as it stands after the run, copied out of its
    state: positions (n, 3), wxyz quaternions (n, 4), features (n, F), the
    decoder's layers [(W (in, out), b)], and the query's constants from the
    configuration."""
    positions: torch.Tensor
    quats: torch.Tensor
    features: torch.Tensor
    layers: list
    nn_k: int
    max_valid_dist2: float
    idw_eps: float
    sdf_scale: float
    rotate_offsets: bool     # after a pose-graph optimisation


def sdf_scale(cfg_values: dict) -> float:
    """The decoder's output scale: under the BCE loss the logistic-Gaussian
    ratio times the sigmoid's sigma (PIN-SLAM model/decoder.py), else 1."""
    if cfg_values["main_loss_type"] == "bce":
        return float(cfg_values["logistic_gaussian_ratio"]) * float(cfg_values["sigma_sigmoid_m"])
    return 1.0


def _rotate_into(quat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q)^T v for wxyz unit quaternions: an offset vector expressed in the
    neighbour's own frame."""
    w, x, y, z = quat.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
        -2)
    return torch.einsum("...ji,...j->...i", R, v)


def _mlp(layers, h: torch.Tensor) -> torch.Tensor:
    for i, (W, b) in enumerate(layers):
        h = h @ W.to(F64)
        if b is not None:
            h = h + b.to(F64)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[..., 0]


def map_sdf(m: MapSnapshot, q: torch.Tensor, chunk: int = 1024):
    """(SDF (n,) float64, neighbours found (n,)) of the map at queries ``q``:
    the k nearest map points within sqrt(max_valid_dist2), weights
    1 / (d^2 + eps) normalised, each neighbour's decode of [its feature, the
    offset q - p (in its own frame after PGO)] times the SDF scale, blended
    by the weights."""
    P = m.positions.to(F64)
    out, counts = [], []
    r = math.sqrt(m.max_valid_dist2)
    for c in range(0, q.shape[0], chunk):
        qc = q[c:c + chunk].to(F64)
        lo, hi = qc.min(0).values - r, qc.max(0).values + r
        near = torch.nonzero(((P >= lo) & (P <= hi)).all(1)).reshape(-1)
        if near.numel() == 0:
            out.append(torch.zeros(qc.shape[0], dtype=F64, device=q.device))
            counts.append(torch.zeros(qc.shape[0], dtype=torch.int64, device=q.device))
            continue
        d2 = torch.sum((qc[:, None, :] - P[near][None]) ** 2, -1)           # (c, n)
        k = min(m.nn_k, near.numel())
        d2k, j = torch.topk(d2, k, dim=1, largest=False)
        valid = d2k <= m.max_valid_dist2
        idx = near[j]
        w = torch.where(valid, 1.0 / (d2k + m.idw_eps), torch.zeros_like(d2k))
        w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-300)
        vec = qc[:, None, :] - P[idx]
        if m.rotate_offsets:
            vec = _rotate_into(m.quats[idx].to(F64), vec)
        h = torch.cat([m.features[idx].to(F64), vec], -1)
        sdf = torch.sum(_mlp(m.layers, h) * w, dim=1) * m.sdf_scale
        out.append(sdf)
        counts.append(valid.sum(1))
    return torch.cat(out), torch.cat(counts)


def crop_range(points: np.ndarray, cfg_values: dict) -> float:
    """The range a frame is mapped to: ``max_range_m``, or with the adaptive
    crop twice the scan's smaller horizontal half-extent, at most that
    (PIN-SLAM dataset/slam_dataset.py)."""
    rmax = float(cfg_values["max_range_m"])
    if cfg_values.get("adaptive_range_on") and points.shape[0]:
        hi, lo = points.max(0), points.min(0)
        rx = min(abs(hi[0]), abs(lo[0]))
        ry = min(abs(hi[1]), abs(lo[1]))
        rmax = min(rmax, 2.0 * max(rx, ry))
    return rmax


def _t(T: np.ndarray) -> np.ndarray:
    return np.asarray(T, np.float64)[..., :3, 3]


def pose_numbers(est: List[np.ndarray], gt: np.ndarray) -> Dict[str, float]:
    """The pose books against ground truth over every frame they hold: the
    largest position error, and the largest error of a frame-to-frame
    translation (the odometry increment)."""
    n = len(est)
    E = np.stack([np.asarray(T, np.float64) for T in est])
    G = np.asarray(gt[:n], np.float64)
    err = np.linalg.norm(_t(E) - _t(G), axis=1)
    out = {"pose_err_max_m": float(err.max()), "rpe_max_m": 0.0,
           "at_frame.pose_err_max": int(err.argmax()), "at_frame.rpe_max": 0}
    if n > 1:
        dE = np.einsum("nji,nj->ni", E[:-1, :3, :3], _t(E[1:]) - _t(E[:-1]))
        dG = np.einsum("nji,nj->ni", G[:-1, :3, :3], _t(G[1:]) - _t(G[:-1]))
        rpe = np.linalg.norm(dE - dG, axis=1)
        out["rpe_max_m"] = float(rpe.max())
        out["at_frame.rpe_max"] = int(rpe.argmax()) + 1
    return out


def ate_rmse(est: List[np.ndarray], gt: np.ndarray, first: int) -> float:
    """Position RMSE of poses est[0..] against gt[first..], unaligned (the
    run starts at the ground truth of its first frame)."""
    E = np.stack([np.asarray(T, np.float64) for T in est])
    G = np.asarray(gt[first:first + len(est)], np.float64)
    return float(np.sqrt(np.mean(np.sum((_t(E) - _t(G)) ** 2, axis=1))))


def sdf_queries(gen, est: List[np.ndarray], cfg_values: dict, sample: dict, seed: int,
                stream: int = 3):
    """(queries in the run's frame (m, 3), true SDF (m,)) drawn from the
    seed: ``sample["frames"]`` frames among those processed, up to
    ``sample["points"]`` returns each within the mapped range, offsets
    uniform in +-``sample["offset_m"]``."""
    from slambench.seeds import torch_gen

    dev = gen.device
    g = torch_gen(seed, stream, dev)
    n_done = len(est)
    n_f = min(int(sample["frames"]), n_done)
    frames = torch.randperm(n_done, generator=g, device=dev)[:n_f].sort().values.tolist()
    qs, truth = [], []
    for i in frames:
        sensor_pts, world, d_w = gen.hits(i, noise=False)
        rng = torch.linalg.norm(sensor_pts, dim=1)
        rmax = crop_range(gen.hits(i, noise=True)[0].cpu().numpy(), cfg_values)
        ok = torch.nonzero((rng > float(cfg_values["min_range_m"])) & (rng < rmax)
                           & (sensor_pts[:, 2] > float(cfg_values["min_z_m"]))).reshape(-1)
        if ok.numel() == 0:
            continue
        pick = ok[torch.randperm(ok.numel(), generator=g, device=dev)[:int(sample["points"])]]
        delta = (2 * torch.rand(pick.numel(), generator=g, device=dev, dtype=F64) - 1) \
            * float(sample["offset_m"])
        q_true = world[pick] - delta[:, None] * d_w[pick]
        truth.append(gen.truth_sdf(q_true))
        E = torch.as_tensor(np.asarray(est[i], np.float64), device=dev)
        G = torch.as_tensor(gen.pose(i), device=dev)
        A = E @ torch.linalg.inv(G)
        qs.append(q_true @ A[:3, :3].T + A[:3, 3])
    return torch.cat(qs), torch.cat(truth)


def sdf_numbers(m: MapSnapshot, q: torch.Tensor, truth: torch.Tensor,
                sign_min_m: float = 0.1) -> Dict[str, float]:
    """The map's SDF against the truth at the queries: the median and 90th
    percentile of the absolute error (a query with no neighbour counts
    ``NO_NEIGHBOUR_ERR_M``), the share of queries with no neighbour, and
    among the queries at least ``sign_min_m`` from a surface the share whose
    SDF has the wrong sign (free space taken for inside, or inside for free
    space; a query with no neighbour counts as wrong)."""
    sdf, nn = map_sdf(m, q)
    covered = nn > 0
    err = torch.where(covered, torch.abs(sdf - truth), torch.full_like(sdf, NO_NEIGHBOUR_ERR_M))
    far = torch.abs(truth) >= sign_min_m
    wrong = (~covered) | (torch.sign(sdf) != torch.sign(truth))
    return {"sdf_err_p50_m": float(torch.quantile(err, 0.5)),
            "sdf_err_p90_m": float(torch.quantile(err, 0.9)),
            "sdf_uncovered_share": float((~covered).double().mean()),
            "sdf_sign_err_share": float(wrong[far].double().mean()) if bool(far.any())
            else 1.0}
