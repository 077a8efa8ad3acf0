"""A plain reference of the two mechanisms a handheld LiDAR profile adds to
the main path: deskewing a sweep with its points' times, and the loss and
gradients of sliding-window bundle adjustment (BA).  Plain PyTorch in
float64 with TF32 off; it imports nothing of ``pin_slam_torch``, of JAX or
of the JAX package, and reuses only ``slambench/reference.py``'s decode
pieces (the map container, the MLP, the rotation into a neighbour's frame).

Deskew (upstream PIN-SLAM ``utils/tools.py`` ``deskewing``): the points'
times are normalised to [0, 1] over the sweep (min to max); a point at
normalised time s is moved into the sensor's frame at the sweep's ``mid``
instant by the motion's share u = s - mid: the rotation is the slerp from
the identity to the sweep's rotation at u, the translation u times the
sweep's translation.  The slerp from the identity is the geodesic
exp(u log R), which this file computes from the rotation's axis and angle
(Rodrigues), not from quaternions.

BA (the port's ``mapper.ba_value_and_grad``; PIN-SLAM's published system has
no BA, the JAX package adds it): each sample's world point is
exp(xi[ts - window_start]) T[ts] p for a sample of a frame in the window,
T[ts] p before it; exp is the SE(3) exponential of the twist (rotation
first, then translation), taken here as the 4 x 4 matrix exponential.  Its
SDF is the inverse-distance-weighted blend of its neighbours' decodes, as
``reference.map_sdf`` computes it; the loss is the mean of sdf^2 over the
valid samples, and the gradients in the map's features and in xi come from
autograd in float64.

The neighbour rule: the ``nn_k`` nearest map points by Euclidean distance
among those within sqrt(``max_valid_dist2``) of the sample (exact kNN,
``exact_neighbours``), found without gradient; the weights 1 / (d^2 + eps),
normalised over the neighbours found, and the offsets q - p (rotated into
each neighbour's frame by its quaternion, as the program's BA query always
does; identity quaternions leave them as they are) carry the gradient.
The program's kNN probes a template of voxel cells around the sample
(``num_nei_cells``, ``search_alpha``) and a hash of them, so it can miss a
point that lies within the radius but outside the template, or behind a
hash collision: compare the two only at samples where both pick the same
neighbours (``same_neighbours``), and count how often they differ.

Departures from the published description, all of them the program's:
the motion is the last frame-to-frame odometry transform (a constant
velocity), and the sweep's mid instant is 0.5; BA decodes per neighbour and
blends (the configuration's ``weighted_first`` false), with the decoder
frozen.
"""

from __future__ import annotations

import math

import torch

from slambench import reference as ref

F64 = torch.float64
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------------
# deskew
# ----------------------------------------------------------------------


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rotation_log(R: torch.Tensor) -> torch.Tensor:
    """The axis-angle vector (3,) of a rotation matrix with an angle below
    pi."""
    R = R.to(F64)
    cos = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    angle = torch.arccos(cos)
    vee = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if float(angle) < 1e-12:
        return 0.5 * vee
    return angle / (2.0 * torch.sin(angle)) * vee


def rotation_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp of axis-angle vectors (..., 3) -> (..., 3, 3)."""
    w = w.to(F64)
    angle = torch.linalg.norm(w, dim=-1)[..., None, None]
    K = _hat(w)
    eye = torch.eye(3, dtype=F64, device=w.device).expand(K.shape)
    small = angle < 1e-12
    a = torch.where(small, torch.ones_like(angle), torch.sin(angle) / torch.where(
        small, torch.ones_like(angle), angle))
    b = torch.where(small, torch.full_like(angle, 0.5), (1.0 - torch.cos(angle)) / torch.where(
        small, torch.ones_like(angle), angle) ** 2)
    return eye + a * K + b * (K @ K)


def deskew(points: torch.Tensor, times: torch.Tensor, motion: torch.Tensor,
           mid: float = 0.5) -> torch.Tensor:
    """Each point (N, 3), taken at its own time (N,), moved into the sensor's
    frame at the sweep's ``mid`` instant, in float64: the rotation
    exp(u log R) and the translation u t of the sweep's motion (4, 4), with
    u the point's time normalised over the sweep less ``mid``."""
    p = points.to(F64)
    t = times.to(F64)
    M = motion.to(F64).to(p.device)
    span = t.max() - t.min()
    u = (t - t.min()) / torch.clamp(span, min=1e-300) - mid
    R_u = rotation_exp(u[:, None] * rotation_log(M[:3, :3])[None, :])
    return torch.einsum("nij,nj->ni", R_u, p) + u[:, None] * M[:3, 3][None, :]


# ----------------------------------------------------------------------
# bundle adjustment
# ----------------------------------------------------------------------


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of twists (W, 6), rotation first: the matrix
    exponential of [[hat(w), v], [0, 0]] (W, 4, 4)."""
    X = torch.zeros((xi.shape[0], 4, 4), dtype=xi.dtype, device=xi.device)
    X = X + torch.nn.functional.pad(_hat(xi[:, :3]), (0, 1, 0, 1))
    X = X + torch.nn.functional.pad(xi[:, 3:, None], (3, 0, 0, 1))
    return torch.linalg.matrix_exp(X)


@torch.no_grad()
def exact_neighbours(positions: torch.Tensor, q: torch.Tensor, k: int,
                     max_valid_dist2: float, cell_m: float = 4.0, chunk: int = 256):
    """Indices (m, k) of the ``k`` nearest ``positions`` (n, 3) of each query
    ``q`` (m, 3) within sqrt(``max_valid_dist2``), nearest first, -1 where
    fewer lie within reach.  Float64; the queries are taken in chunks of
    nearby ones (sorted by a ``cell_m`` grid), each against the points in
    its bounding box grown by the reach."""
    P = positions.to(F64)
    Q = q.to(F64)
    m = Q.shape[0]
    out = torch.full((m, k), -1, dtype=torch.int64, device=Q.device)
    if m == 0 or P.shape[0] == 0:
        return out
    r = math.sqrt(max_valid_dist2)
    cell = torch.floor(Q / cell_m).to(torch.int64)
    cell = cell - cell.min(0).values
    span = cell.max(0).values + 1
    key = (cell[:, 0] * span[1] + cell[:, 1]) * span[2] + cell[:, 2]
    order = torch.argsort(key, stable=True)
    for c in range(0, m, chunk):
        sel = order[c:c + chunk]
        qc = Q[sel]
        lo, hi = qc.min(0).values - r, qc.max(0).values + r
        near = torch.nonzero(((P >= lo) & (P <= hi)).all(1)).reshape(-1)
        if near.numel() == 0:
            continue
        d2 = torch.sum((qc[:, None, :] - P[near][None]) ** 2, -1)
        kk = min(k, near.numel())
        d2k, j = torch.topk(d2, kk, dim=1, largest=False)
        idx = torch.where(d2k <= max_valid_dist2, near[j], torch.full_like(j, -1))
        out[sel, :kk] = idx
    return out


def blended_sdf(m: ref.MapSnapshot, features: torch.Tensor, q: torch.Tensor,
                nbr: torch.Tensor) -> torch.Tensor:
    """SDF (m,) at queries ``q`` from the neighbours ``nbr`` (m, k) (-1:
    none): each neighbour's decode of [its feature, the offset q - p (in its
    own frame with ``m.rotate_offsets``)] times the SDF scale, blended by the
    normalised inverse-distance weights; differentiable in ``features`` and
    ``q``."""
    valid = nbr >= 0
    idx = torch.where(valid, nbr, torch.zeros_like(nbr))
    P = m.positions.to(F64).to(q.device)
    vec = q[:, None, :] - P[idx]
    d2 = torch.sum(vec ** 2, -1)
    w = torch.where(valid, 1.0 / (d2 + m.idw_eps), torch.zeros_like(d2))
    w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-300)
    if m.rotate_offsets:
        vec = ref._rotate_into(m.quats.to(F64).to(q.device)[idx], vec)
    h = torch.cat([features[idx], vec], -1)
    return torch.sum(ref._mlp(m.layers, h) * w, dim=1) * m.sdf_scale


def ba_world_points(poses_full: torch.Tensor, window_start: int, xi: torch.Tensor,
                    local: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """exp(xi[ts - window_start]) T[ts] p inside the window, T[ts] p before
    it (float64, differentiable in ``xi``)."""
    T = poses_full.to(F64)[ts]
    win = ts >= window_start
    wi = torch.clamp(ts - window_start, 0, xi.shape[0] - 1)
    dT = se3_exp(xi)[wi]
    T = torch.where(win[:, None, None], dT @ T, T)
    return torch.einsum("nij,nj->ni", T[:, :3, :3], local.to(F64)) + T[:, :3, 3]


def ba_loss_and_grads(m: ref.MapSnapshot, poses_full: torch.Tensor, window_start: int,
                      xi: torch.Tensor, local: torch.Tensor, ts: torch.Tensor,
                      valid: torch.Tensor, nbr: torch.Tensor = None):
    """BA's loss at one batch (the mean of sdf^2 over the ``valid`` samples)
    and its gradients in the map's features (n, F) and in the window's
    corrections ``xi`` (W, 6), in float64: (loss, d loss / d features,
    d loss / d xi, the neighbours used (B, k)).  ``nbr`` defaults to
    ``exact_neighbours`` of each sample's world point."""
    with torch.enable_grad():
        f = m.features.detach().to(F64).requires_grad_(True)
        x = xi.detach().to(F64).requires_grad_(True)
        ts = ts.to(torch.int64)
        world = ba_world_points(poses_full, window_start, x, local, ts)
        if nbr is None:
            nbr = exact_neighbours(m.positions, world.detach(), m.nn_k, m.max_valid_dist2)
        sdf = blended_sdf(m, f, world, nbr)
        per = torch.where(valid, sdf ** 2, torch.zeros_like(sdf))
        loss = per.sum() / torch.clamp(valid.sum(), min=1)
        g_f, g_x = torch.autograd.grad(loss, (f, x))
    return loss.detach(), g_f, g_x, nbr


def same_neighbours(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) whether two neighbour lists (B, k), -1 for none, hold the same
    set of points."""
    big = torch.iinfo(torch.int64).max
    sa = torch.sort(torch.where(a >= 0, a, torch.full_like(a, big)), dim=1).values
    sb = torch.sort(torch.where(b >= 0, b, torch.full_like(b, big)), dim=1).values
    return torch.all(sa == sb, dim=1)


def adam_steps(m: ref.MapSnapshot, poses_full, window_start, xi, batches, lr: float,
               eps: float, pose_lr_ratio: float = 0.1):
    """``len(batches)`` iterations of BA from the map's features and ``xi``:
    Adam (0.9, 0.99, ``eps``, bias-corrected, rate ``lr``) on the features
    and on xi, xi moving by ``pose_lr_ratio`` times its step; ``batches`` is
    [(local, ts, valid, nbr or None)].  The feature row given as
    ``m.features``'s last row (a sentinel) is held at zero.  Returns
    (features, xi, losses), float64."""
    feats = m.features.detach().to(F64).clone()
    x = xi.detach().to(F64).clone()
    state = [[torch.zeros_like(feats), torch.zeros_like(feats)],
             [torch.zeros_like(x), torch.zeros_like(x)]]
    losses = []
    for t, (local, ts, valid, nbr) in enumerate(batches, start=1):
        mt = ref.MapSnapshot(**{**m.__dict__, "features": feats})
        loss, g_f, g_x, _ = ba_loss_and_grads(mt, poses_full, window_start, x, local, ts,
                                              valid, nbr)
        steps = []
        for (mom, var), g in zip(state, (g_f, g_x)):
            mom.mul_(0.9).add_(0.1 * g)
            var.mul_(0.99).add_(0.01 * g * g)
            steps.append(-lr * (mom / (1 - 0.9 ** t)) / (torch.sqrt(var / (1 - 0.99 ** t)) + eps))
        feats = feats + steps[0]
        feats[-1] = 0.0
        x = x + pose_lr_ratio * steps[1]
        losses.append(float(loss))
    return feats, x, losses
