"""Mesh reconstruction metrics, the port's copy of ``pin_slam_tpu/eval/mesh.py``:
Chamfer-L1/L2 and precision/recall/F-score through a k-d tree (the
native extension's when it is loadable, else scipy's cKDTree).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        seed: int = 0) -> np.ndarray:
    """Uniform area-weighted surface sampling (replaces o3d sample_points)."""
    rng = np.random.default_rng(seed)
    fv = verts[faces].astype(np.float64)
    areas = 0.5 * np.linalg.norm(np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), axis=1)
    if areas.sum() <= 0:
        return verts[:n].astype(np.float64)
    pick = rng.choice(faces.shape[0], n, p=areas / areas.sum())
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    tri = fv[pick]
    return tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) + v * (tri[:, 2] - tri[:, 0])


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Per-point nearest-neighbor distance src -> dst
    (ref eval/eval_mesh_utils.py:94-125 ``nn_correspondance``).
    Uses the C++ k-d tree when the native extension is built."""
    import os

    from pin_slam_torch.utils import native

    if os.environ.get("PIN_NATIVE", "1") != "0" and native.available() and len(dst):
        return native.nn_distances(np.asarray(src), np.asarray(dst)).astype(np.float64)
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1)
    return d


def eval_mesh(mesh_verts: np.ndarray, mesh_faces: np.ndarray, gt_points: np.ndarray,
              n_samples: int = 100_000, threshold: float = 0.05,
              truncation_acc: float = 0.5, truncation_com: float = 0.5,
              seed: int = 0) -> Dict[str, float]:
    """Chamfer-L1/L2 + precision/recall/F-score @ threshold
    (ref eval/eval_mesh_utils.py:8-91).

    truncation_acc/_com: distances above these are dropped (accuracy) or
    clamped (completeness), matching the reference's outlier handling.
    """
    pred = sample_mesh_surface(mesh_verts, mesh_faces,
                               min(n_samples, max(len(mesh_verts), 1) * 4), seed)
    gt = np.asarray(gt_points, dtype=np.float64)
    if len(gt) > n_samples:
        rng = np.random.default_rng(seed)
        gt = gt[rng.choice(len(gt), n_samples, replace=False)]

    d_pred2gt = nn_distances(pred, gt)       # accuracy
    d_gt2pred = nn_distances(gt, pred)       # completeness

    acc = d_pred2gt[d_pred2gt < truncation_acc]
    com = np.minimum(d_gt2pred, truncation_com)

    precision = float((d_pred2gt < threshold).mean())
    recall = float((d_gt2pred < threshold).mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)

    return {
        "chamfer_l1": float(0.5 * (acc.mean() + com.mean())) if acc.size else float(com.mean()),
        "chamfer_l2": float(np.sqrt(0.5 * ((acc**2).mean() + (com**2).mean()))) if acc.size else float(np.sqrt((com**2).mean())),
        "precision": precision,
        "recall": recall,
        "fscore": float(f1),
        "mean_accuracy_m": float(acc.mean()) if acc.size else np.inf,
        "mean_completeness_m": float(com.mean()),
    }
