"""SE(3) / quaternion geometry, torch counterpart of
``pin_slam_tpu/ops/transforms.py`` (wxyz quaternions; device math float32,
host pose bookkeeping float64 numpy)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """One 4x4 (or 3x4) homogeneous transform applied to (N,3) points."""
    R = pose[:3, :3].to(points.dtype)
    t = pose[:3, 3].to(points.dtype)
    return points @ R.T + t


def transform_points_batch(points: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Per-point transforms: points (N,3), poses (N,4,4)."""
    R = poses[:, :3, :3].to(points.dtype)
    t = poses[:, :3, 3].to(points.dtype)
    return torch.einsum("nij,nj->ni", R, points) + t


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def apply_quaternion_rotation(quat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Passive rotation p' = q^-1 p q, batch-broadcast."""
    quat_w = quat[..., :1]
    quat_xyz = -quat[..., 1:]
    t = 2.0 * _cross(quat_xyz, points)
    return points + quat_w * t + _cross(quat_xyz, t)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack((
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2), dim=-1)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Batch [...,3,3] -> wxyz quaternion (maximal-pivot construction)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=1e-12))
    qx = 0.5 * torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12))
    qy = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12))
    qz = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12))
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz], -1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    best = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = torch.stack([
        1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2)], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between unit quaternions, u in [0,1], broadcast
    over u."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w1 = torch.where(small, u, torch.sin(u * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1)], dim=-2)


def so3_expmap(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues with a Taylor branch at small angles."""
    angle = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True) + 1e-24)
    small = angle < 1e-7
    safe = torch.where(small, torch.ones_like(angle), angle)
    A = torch.where(small, 1.0 - angle ** 2 / 6.0, torch.sin(safe) / safe)[..., None]
    B = torch.where(small, 0.5 - angle ** 2 / 24.0, (1.0 - torch.cos(safe)) / safe ** 2)[..., None]
    S = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(S.shape)
    return eye + A * S + B * (S @ S)


def so3_logmap(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = angle < 1e-6
    denom = 2.0 * torch.where(small, torch.ones_like(angle), torch.sin(angle))
    scale = torch.where(small, 0.5 + angle ** 2 / 12.0, angle / denom)
    return scale[..., None] * vee


def se3_expmap(xi: torch.Tensor) -> torch.Tensor:
    """se(3) [...,6] (rotation first, then translation) -> [...,4,4]."""
    w, v = xi[..., :3], xi[..., 3:]
    angle = torch.sqrt(torch.sum(w * w, dim=-1, keepdim=True) + 1e-24)
    small = angle < 1e-7
    safe = torch.where(small, torch.ones_like(angle), angle)
    A = torch.where(small, 1.0 - angle ** 2 / 6.0, torch.sin(safe) / safe)[..., None]
    B = torch.where(small, 0.5 - angle ** 2 / 24.0, (1.0 - torch.cos(safe)) / safe ** 2)[..., None]
    C = torch.where(small, 1.0 / 6.0 - angle ** 2 / 120.0,
                    (safe - torch.sin(safe)) / safe ** 3)[..., None]
    S = skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(S.shape)
    R = eye + A * S + B * (S @ S)
    V = eye + B * S + C * (S @ S)
    t = (V @ v[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype,
                          device=xi.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_logmap(T: torch.Tensor) -> torch.Tensor:
    w = so3_logmap(T[..., :3, :3])
    angle = torch.linalg.norm(w, dim=-1, keepdim=True)
    small = angle < 1e-7
    safe = torch.where(small, torch.ones_like(angle), angle)
    half = safe * 0.5
    cot = half / torch.tan(half)
    coef = torch.where(small, 1.0 / 12.0 + angle ** 2 / 720.0, (1.0 - cot) / safe ** 2)[..., None]
    S = skew(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(S.shape)
    Vinv = eye - 0.5 * S + coef * (S @ S)
    v = (Vinv @ T[..., :3, 3:])[..., 0]
    return torch.cat([w, v], dim=-1)


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle in radians of [...,3,3] matrices."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


# ----------------------------------------------------------------------
# deskewing (motion undistortion)
# ----------------------------------------------------------------------


def deskew_points(points: torch.Tensor, ts: torch.Tensor, rel_pose: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  ts_mid_pose: float = 0.5) -> torch.Tensor:
    """Slerp-based motion undistortion on the tensors' device.

    points (N,3) in the sensor frame at each point's own time; ts (N,) per
    point (any scale: min/max normalised to [0,1], over the ``valid`` rows
    only when a mask is given); rel_pose 4x4, the motion of one sweep
    (T_last<-cur).  Each point moves into the frame of the sweep's
    ``ts_mid_pose`` instant: p' = R(u) p + u t with u = ts_norm - ts_mid_pose,
    R(u) the slerp from the identity to the motion's rotation."""
    if valid is None:
        tmin, tmax = torch.min(ts), torch.max(ts)
    else:
        tmin = torch.min(torch.where(valid, ts, torch.full_like(ts, float("inf"))))
        tmax = torch.max(torch.where(valid, ts, torch.full_like(ts, float("-inf"))))
    u = (ts - tmin) / torch.clamp(tmax - tmin, min=1e-9) - ts_mid_pose
    q1 = rotmat_to_quat(rel_pose[:3, :3].to(points.dtype))
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=points.dtype, device=points.device)
    R_u = quat_to_rotmat(quat_slerp(q0[None, :], q1[None, :], u[:, None]))
    t_u = u[:, None] * rel_pose[:3, 3].to(points.dtype)
    return torch.einsum("nij,nj->ni", R_u, points) + t_u


# ----------------------------------------------------------------------
# host (numpy, f64) pose helpers
# ----------------------------------------------------------------------


def np_se3_inverse(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def np_rotation_angle_deg(R: np.ndarray) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))))
