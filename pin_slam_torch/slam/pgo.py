"""Pose-graph optimization on SE(3) — host-side sparse Gauss-Newton/LM.

The PyTorch port's own copy of ``pin_slam_tpu/slam/pgo.py`` (numpy and scipy
only; the port imports nothing from the JAX package).

Replaces the upstream PIN-SLAM gtsam dependency (its utils/pgo.py:13-173): a
fixed prior on frame 0, per-frame odometry BetweenFactors (constant diagonal
covariance or the registration covariance), loop factors, and LM optimization.
Graphs are tiny (O(frames) nodes), so a scipy sparse normal-equations solve is
ample (SURVEY.md section 7.0.6).

Conventions: poses are world<-sensor 4x4 f64; edge (i, j, Z) encodes the
measured relative pose Z = X_i^-1 X_j; residual r = log(Z^-1 X_i^-1 X_j) in
[rot, trans] ordering; left-multiplicative update X <- X exp(dx).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def _skew_batch(v: np.ndarray) -> np.ndarray:
    """(...,3) -> (...,3,3)."""
    S = np.zeros(v.shape[:-1] + (3, 3))
    S[..., 0, 1], S[..., 0, 2] = -v[..., 2], v[..., 1]
    S[..., 1, 0], S[..., 1, 2] = v[..., 2], -v[..., 0]
    S[..., 2, 0], S[..., 2, 1] = -v[..., 1], v[..., 0]
    return S


def se3_inv_batch(T: np.ndarray) -> np.ndarray:
    """(...,4,4) SE(3) inverse via [R^T, -R^T t]."""
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def se3_log_batch(T: np.ndarray) -> np.ndarray:
    """(...,4,4) -> (...,6) [rot, trans], vectorized se3_log."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = np.clip((tr - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    axis = np.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    small = theta < 1e-9
    # theta/(2 sin theta): series 1/2 + theta^2/12 near 0
    sin = np.sin(theta)
    f = np.where(small, 0.5 + theta**2 / 12,
                 theta / np.where(small, 1.0, 2 * sin))
    w = f[..., None] * axis
    S = _skew_batch(w)
    SS = np.einsum("...ij,...jk->...ik", S, S)
    half = theta / 2
    # (1 - half*cot(half))/theta^2 -> 1/12 as theta -> 0
    tan = np.tan(np.where(small, 1.0, half))
    coeff = np.where(small, 1.0 / 12,
                     (1 - half / tan) / np.where(small, 1.0, theta**2))
    Vinv = np.eye(3) - 0.5 * S + coeff[..., None, None] * SS
    v = np.einsum("...ij,...j->...i", Vinv, t)
    return np.concatenate([w, v], axis=-1)


def se3_exp_batch(xi: np.ndarray) -> np.ndarray:
    """(...,6) [rot, trans] -> (...,4,4), vectorized se3_exp."""
    w, v = xi[..., :3], xi[..., 3:]
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-9
    th = np.where(small, 1.0, theta)
    A = np.where(small, 1.0, np.sin(th) / th)
    B = np.where(small, 0.5, (1 - np.cos(th)) / th**2)
    C = np.where(small, 1.0 / 6, (1 - A) / th**2)
    S = _skew_batch(w)
    SS = np.einsum("...ij,...jk->...ik", S, S)
    R = np.eye(3) + A[..., None, None] * S + B[..., None, None] * SS
    V = np.eye(3) + B[..., None, None] * S + C[..., None, None] * SS
    T = np.zeros(xi.shape[:-1] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    T[..., 3, 3] = 1.0
    return T


def adjoint_batch(T: np.ndarray) -> np.ndarray:
    """(...,4,4) -> (...,6,6) SE(3) adjoint in [rot, trans] ordering."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Ad = np.zeros(T.shape[:-2] + (6, 6))
    Ad[..., :3, :3] = R
    Ad[..., 3:, 3:] = R
    Ad[..., 3:, :3] = np.einsum("...ij,...jk->...ik", _skew_batch(t), R)
    return Ad


def se3_log(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    cos = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-9:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return np.concatenate([w, t])
    w = theta / (2 * np.sin(theta)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    S = _skew(w)
    half = theta / 2
    Vinv = np.eye(3) - 0.5 * S + (1 - half / np.tan(half)) / theta**2 * (S @ S)
    return np.concatenate([w, Vinv @ t])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    w, v = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    S = _skew(w)
    if theta < 1e-9:
        R = np.eye(3) + S
        V = np.eye(3) + 0.5 * S
    else:
        A = np.sin(theta) / theta
        B = (1 - np.cos(theta)) / theta**2
        C = (1 - A) / theta**2
        R = np.eye(3) + A * S + B * (S @ S)
        V = np.eye(3) + B * S + C * (S @ S)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def adjoint(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[3:, 3:] = R
    Ad[3:, :3] = _skew(t) @ R
    return Ad


@dataclasses.dataclass
class Edge:
    i: int
    j: int
    Z: np.ndarray                 # measured X_i^-1 X_j
    info: np.ndarray              # 6x6 information matrix (rot, trans)


class PoseGraphManager:
    """API parity with the reference manager (utils/pgo.py:50-173)."""

    def __init__(self, config=None):
        self.config = config
        self.nodes: List[np.ndarray] = []
        self.edges: List[Edge] = []
        self.fixed: List[int] = []
        tran_std = getattr(config, "pgo_tran_std", 0.04) if config else 0.04
        rot_std_deg = getattr(config, "pgo_rot_std", 0.01) if config else 0.01
        self.default_info = self._diag_info(np.radians(rot_std_deg), tran_std)
        self.loop_info = self.default_info
        self.max_iter = getattr(config, "pgo_max_iter", 50) if config else 50
        self.min_loop_idx = int(1e9)
        self.drift_radius = 0.0
        self.pgo_count = 0
        self.last_loop_idx = 0

    @staticmethod
    def _diag_info(rot_std: float, tran_std: float) -> np.ndarray:
        return np.diag(1.0 / np.array([rot_std**2] * 3 + [tran_std**2] * 3))

    # ------------------------------------------------------------------
    def add_frame_node(self, idx: int, pose: np.ndarray) -> None:
        assert idx == len(self.nodes), "nodes must be added in frame order"
        self.nodes.append(np.asarray(pose, dtype=np.float64).copy())
        if idx == 0:
            self.fixed.append(0)

    def add_pose_prior(self, idx: int, pose: np.ndarray, fixed: bool = True) -> None:
        if fixed and idx not in self.fixed:
            self.fixed.append(idx)
        self.nodes[idx] = np.asarray(pose, dtype=np.float64).copy()

    def add_odometry_factor(self, cur_idx: int, prev_idx: int, rel_pose: np.ndarray,
                            cov: Optional[np.ndarray] = None) -> None:
        """(ref utils/pgo.py:81-99). rel_pose = X_prev^-1 X_cur."""
        info = self.default_info if cov is None else np.linalg.inv(cov + 1e-12 * np.eye(6))
        self.edges.append(Edge(prev_idx, cur_idx, np.asarray(rel_pose, np.float64), info))

    def add_loop_factor(self, cur_idx: int, loop_idx: int, rel_pose: np.ndarray,
                        cov: Optional[np.ndarray] = None) -> None:
        """(ref utils/pgo.py:102-120). rel_pose = X_loop^-1 X_cur."""
        info = self.loop_info if cov is None else np.linalg.inv(cov + 1e-12 * np.eye(6))
        self.edges.append(Edge(loop_idx, cur_idx, np.asarray(rel_pose, np.float64), info))
        self.min_loop_idx = min(self.min_loop_idx, loop_idx)

    # ------------------------------------------------------------------
    def optimize_pose_graph(self, lm_lambda: float = 1e-6) -> np.ndarray:
        """LM over all nodes (ref utils/pgo.py:122-157). Returns [N,4,4] poses.

        Fully vectorized over edges (numpy batch SE(3) ops + one COO build per
        iteration): at KITTI-00 scale (4.5k nodes, 50 LM iters per closure) the
        per-edge python triple loop this replaces spent seconds per closure on
        36 scalar appends per block."""
        n = len(self.nodes)
        X = np.stack(self.nodes)                         # (N,4,4)
        fixed = sorted(set(self.fixed))

        EI = np.array([e.i for e in self.edges], np.int64)
        EJ = np.array([e.j for e in self.edges], np.int64)
        Zinv = se3_inv_batch(np.stack([e.Z for e in self.edges]))
        info = np.stack([e.info for e in self.edges])    # (E,6,6)

        def residuals(Xs):
            rel = np.einsum("eij,ejk->eik", se3_inv_batch(Xs[EI]), Xs[EJ])
            r = se3_log_batch(np.einsum("eij,ejk->eik", Zinv, rel))
            return rel, r

        def total_error(Xs):
            _, r = residuals(Xs)
            return float(np.einsum("ei,eij,ej->", r, info, r))

        free_mask = np.ones(6 * n, dtype=bool)
        for fidx in fixed:
            free_mask[6 * fidx:6 * fidx + 6] = False
        # static COO index pattern: 4 blocks (ii, ij, ji, jj) x 36 per edge
        u6 = np.arange(6)
        blk_rows = np.repeat(u6, 6)                      # (36,)
        blk_cols = np.tile(u6, 6)
        rows = np.concatenate([
            (6 * a[:, None] + blk_rows[None, :]).ravel()
            for a in (EI, EI, EJ, EJ)])
        cols = np.concatenate([
            (6 * c[:, None] + blk_cols[None, :]).ravel()
            for c in (EI, EJ, EI, EJ)])

        lam = lm_lambda
        last_err = total_error(X)
        for _ in range(self.max_iter):
            rel, r = residuals(X)
            # right-perturbation jacobians (small-residual approximation
            # J_r ~ I): d r / d xi_j = I, d r / d xi_i = -Ad(rel^-1)
            Ji = -adjoint_batch(se3_inv_batch(rel))      # (E,6,6)
            JiT_info = np.einsum("eji,ejk->eik", Ji, info)
            blk_ii = np.einsum("eij,ejk->eik", JiT_info, Ji)
            blk_ij = JiT_info                            # Ji^T info I
            blk_ji = np.swapaxes(blk_ij, -1, -2)         # I info Ji (info sym)
            blk_jj = info
            vals = np.concatenate([blk_ii.reshape(-1, 36),
                                   blk_ij.reshape(-1, 36),
                                   blk_ji.reshape(-1, 36),
                                   blk_jj.reshape(-1, 36)]).ravel()
            b = np.zeros((n, 6))
            np.add.at(b, EI, np.einsum("eij,ej->ei", JiT_info, r))
            np.add.at(b, EJ, np.einsum("eij,ej->ei", info, r))
            b = b.ravel()

            H = sp.coo_matrix((vals, (rows, cols)), shape=(6 * n, 6 * n)).tocsr()
            H = H + lam * sp.diags(H.diagonal() + 1e-9)
            Hf = H[free_mask][:, free_mask]
            bf = b[free_mask]
            try:
                dx_f = spla.spsolve(Hf.tocsc(), -bf)
            except Exception:
                break
            dx = np.zeros(6 * n)
            dx[free_mask] = dx_f
            X_new = np.einsum("nij,njk->nik", X, se3_exp_batch(dx.reshape(n, 6)))
            X_new[fixed] = X[fixed]
            err = total_error(X_new)
            if err < last_err:
                X = X_new
                if last_err - err < 1e-9 * max(last_err, 1.0):
                    last_err = err
                    break
                last_err = err
                lam = max(lam * 0.5, 1e-9)
            else:
                lam *= 4.0
                if lam > 1e3:
                    break
        self.pgo_count += 1
        self.nodes = [p.copy() for p in X]
        return X.copy()

    # ------------------------------------------------------------------
    def get_pose_diff(self, old_poses: np.ndarray) -> np.ndarray:
        """Per-frame correction new @ old^-1 applied to map points
        (ref utils/pgo.py:162-166 combined with pin_slam.py:209-212)."""
        new_poses = np.stack(self.nodes)
        n = min(len(old_poses), len(new_poses))
        return np.einsum("nij,njk->nik", new_poses[:n],
                         np.linalg.inv(old_poses[:n]))

    def estimate_drift(self, travel_dist: List[float], cur_idx: int,
                       drift_ratio: float = 0.01) -> float:
        """Drift proportional to travel distance since the last loop
        (ref utils/pgo.py:168-173)."""
        d = travel_dist[cur_idx] - travel_dist[self.last_loop_idx]
        self.drift_radius = d * drift_ratio
        return self.drift_radius

    def plot_loops(self, path: str, vis_now: bool = False) -> None:
        """Bird's-eye trajectory plot with loop-closure edges drawn in red
        (ref utils/pgo.py:175-211)."""
        if not self.nodes:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        xyz = np.stack([T[:3, 3] for T in self.nodes])
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(xyz[:, 0], xyz[:, 1], "-", color="tab:blue", lw=1,
                label="trajectory")
        loops = [e for e in self.edges if abs(e.j - e.i) > 1]
        for e in loops:
            ax.plot([xyz[e.i, 0], xyz[e.j, 0]], [xyz[e.i, 1], xyz[e.j, 1]],
                    "-", color="tab:red", lw=0.8)
        if loops:
            ax.plot([], [], "-", color="tab:red", lw=0.8,
                    label=f"{len(loops)} loop edges")
        ax.set_aspect("equal")
        ax.set_xlabel("x (m)")
        ax.set_ylabel("y (m)")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    def write_g2o(self, path: str) -> None:
        """(ref utils/pgo.py:159-160)."""
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for i, T in enumerate(self.nodes):
                q = Rotation.from_matrix(T[:3, :3]).as_quat()
                t = T[:3, 3]
                f.write(f"VERTEX_SE3:QUAT {i} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
            for e in self.edges:
                q = Rotation.from_matrix(e.Z[:3, :3]).as_quat()
                t = e.Z[:3, 3]
                upper = []
                for u in range(6):
                    for v in range(u, 6):
                        upper.append(e.info[u, v])
                f.write(f"EDGE_SE3:QUAT {e.i} {e.j} {t[0]} {t[1]} {t[2]} "
                        f"{q[0]} {q[1]} {q[2]} {q[3]} " + " ".join(map(str, upper)) + "\n")
