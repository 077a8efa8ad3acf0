"""Incremental mapping, torch counterpart of ``pin_slam_tpu/slam/mapper.py``
(main-path and loop-closure subset): the replay pool, the append-time kNN
with its cached geometry, its re-derivation after a pose-graph optimisation,
and the cached training loop on the kernel path (row gather -> train/eikonal
kernels -> deterministic row scatter -> Adam).

Pool rows keep the JAX package's packed layout (see ``P_*``): sample
coordinates, label, weight, frame id, sensor-frame coordinates, the k = 6
GLOBAL neighbour ids (value-cast float32, -1 = none), their normalized IDW
weights and the blended offset vector (plus per-neighbour vectors when
``weighted_first`` is False).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.ops import rank_kernel, rows as rowk, train_kernel
from pin_slam_torch.ops.hash3d import grid_coords
from pin_slam_torch.ops.scatter import nonzero_static
from pin_slam_torch.ops.transforms import apply_quaternion_rotation
from pin_slam_torch.ops.voxel import sqnorm3
from pin_slam_torch.utils.platform import not_ported


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    pool_capacity: int
    new_idx_capacity: int
    bs: int
    bs_new_sample: int
    iters: int
    lr: float
    adam_eps: float
    sigma_sigmoid: float
    sdf_scale: float
    loss_weight_on: bool
    ekional_loss_on: bool
    weight_e: float
    gradient_decimation: int
    num_grad_step: float
    surface_sample_range: float
    window_radius: float = 60.0
    new_certainty_thre: float = 1.0
    vec_dim: int = 3
    weighted_first: bool = True

    @property
    def pool_dim(self) -> int:
        return pool_dim(self.vec_dim) + (0 if self.weighted_first else 6 * self.vec_dim)

    @staticmethod
    def from_config(cfg) -> "MapperConfig":
        if cfg.pos_encoding_band > 0:
            raise not_ported("pos_encoding_band > 0")
        return MapperConfig(
            vec_dim=3,
            weighted_first=cfg.weighted_first,
            pool_capacity=int(cfg.pool_capacity),
            new_idx_capacity=min(int(cfg.pool_capacity), 1 << 17),
            bs=cfg.bs, bs_new_sample=cfg.bs_new_sample, iters=cfg.iters,
            lr=cfg.lr, adam_eps=cfg.adam_eps, sigma_sigmoid=cfg.sigma_sigmoid_m,
            sdf_scale=cfg.sdf_scale, loss_weight_on=cfg.loss_weight_on,
            ekional_loss_on=cfg.ekional_loss_on, weight_e=cfg.weight_e,
            gradient_decimation=cfg.gradient_decimation,
            num_grad_step=cfg.voxel_size_m * cfg.num_grad_step_ratio,
            surface_sample_range=cfg.surface_sample_range_m,
            window_radius=cfg.window_radius,
            new_certainty_thre=cfg.new_certainty_thre)


P_COORD = slice(0, 3)
P_LABEL = 3
P_WEIGHT = 4
P_TS = 5
P_LOCAL = slice(6, 9)
P_KNN = slice(9, 15)
P_W = slice(15, 21)
P_VEC0 = 21


def pool_dim(vec_dim: int = 3) -> int:
    return P_VEC0 + vec_dim


@dataclasses.dataclass
class PoolState:
    """Replay pool, fixed capacity P (P+1 rows, last = padding)."""
    rows: torch.Tensor       # (P+1, pool_dim) f32
    head: torch.Tensor       # () int64 ring write position
    fill: torch.Tensor       # () int64 valid entries
    new_idx: torch.Tensor    # (N_new,) int64 pool indices of new-region samples
    new_count: torch.Tensor  # () int64


def init_pool(mcfg: MapperConfig, device=None) -> PoolState:
    P = mcfg.pool_capacity
    rows = torch.zeros((P + 1, mcfg.pool_dim), dtype=torch.float32, device=device)
    rows[:, P_KNN] = -1.0
    z = torch.zeros((), dtype=torch.int64, device=device)
    return PoolState(rows=rows, head=z.clone(), fill=z.clone(),
                     new_idx=torch.zeros((mcfg.new_idx_capacity,), dtype=torch.int64,
                                         device=device),
                     new_count=z.clone())


def pool_from_numpy(src, device=None) -> PoolState:
    """A JAX ``PoolState`` (or any object with its array attributes) -> PoolState."""
    def t(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)
    return PoolState(rows=t(src.rows, torch.float32), head=t(src.head, torch.int64),
                     fill=t(src.fill, torch.int64), new_idx=t(src.new_idx, torch.int64),
                     new_count=t(src.new_count, torch.int64))


def idw_blend(points: torch.Tensor, nbr_pos: torch.Tensor, valid: torch.Tensor,
              quat: Optional[torch.Tensor] = None, return_per_neighbor: bool = False):
    """Normalized IDW weights + weight-blended offset vector at fixed
    neighbour positions.  points (...,3), nbr_pos (...,k,3), valid (...,k),
    quat (...,k,4) or None: each offset vector rotated into its neighbour's
    frame (identity until a pose-graph optimisation deforms the map)."""
    vec = points[..., None, :] - nbr_pos
    dist2 = torch.where(valid, sqnorm3(vec), torch.full_like(vec[..., 0], npts._INVALID_DIST2))
    if quat is not None:
        vec = apply_quaternion_rotation(quat, vec)
    vec = torch.where(valid[..., None], vec, torch.zeros_like(vec))
    _, _, w = npts.idw_weights(dist2, valid, 1e-15)
    vec_blend = torch.einsum("...k,...kp->...p", w, vec)
    if return_per_neighbor:
        return w, vec_blend, vec
    return w, vec_blend


def _probe_rank(lm: npts.LocalMap, mc: npts.MapConfig, offsets, probe_pts: torch.Tensor,
                query_pts: torch.Tensor, k: int):
    """Probe the local hash around ``probe_pts`` and rank each group's shared
    candidate set by every ``query_pts`` row's exact distance.  probe_pts
    (G,3); query_pts (G,n,3).  On the brick layout the probe and the ranking
    are one kernel (``rank_kernel.probe_rank_brick``); the per-cell layout
    gathers the rows in torch, then ranks them.  Returns (gidx (G,n,k)
    int32, pos (G,n,k,3), valid (G,n,k))."""
    if isinstance(offsets, npts.ProbeTemplate) and mc.nsub > 1:
        return rank_kernel.probe_rank_brick(
            lm.hash_rows, offsets.bricks, offsets.memb, probe_pts, query_pts, k,
            mc.local_capacity, mc.max_valid_dist2, mc.voxel_size, mc.brick, mc.brick_rows)
    cells_t = offsets.cells if isinstance(offsets, npts.ProbeTemplate) else offsets
    G = query_pts.shape[0]
    grid = grid_coords(probe_pts, mc.voxel_size)
    cells = grid[:, None, :] + cells_t[None, :, :].to(grid.dtype)
    rows = lm.hash_rows[npts.subcell_hash(mc, cells)]              # (G,K,·)
    rows_fm = rows[..., :5].transpose(1, 2).reshape(G, -1)
    return rank_kernel.probe_rank(rows_fm.contiguous(), query_pts.contiguous(), k,
                                  mc.local_capacity, mc.max_valid_dist2)


def dedup_group_probe(lm, mc, offsets, probe_pts: torch.Tensor, queries: torch.Tensor,
                      k: int, budget: int, n_g: int):
    """Exact voxel-dedup probe: items whose probe points share a voxel share
    one ball gather (stable key sort, groups of up to ``n_g`` items, the first
    ``budget`` groups probed).  Returns (gidx (N,q,k), pos (N,q,k,3),
    valid (N,q,k), dropped (N,)) in the original item order; items of groups
    past the budget come back all-invalid and flagged ``dropped``."""
    dev = probe_pts.device
    N, q = queries.shape[0], queries.shape[1]
    G_B = max(8, budget)
    gc = grid_coords(probe_pts, mc.voxel_size)
    gc = torch.clamp(gc - torch.min(gc, dim=0).values, 0, 1023).to(torch.int64)
    key = (gc[:, 0] << 20) + (gc[:, 1] << 10) + gc[:, 2]
    ks, order = torch.sort(key, stable=True)
    sp = probe_pts[order]
    sq = queries[order]

    pos_i = torch.arange(N, dtype=torch.int64, device=dev)
    newrun = torch.ones((N,), dtype=torch.bool, device=dev)
    newrun[1:] = ks[1:] != ks[:-1]
    run_start = torch.cummax(torch.where(newrun, pos_i, torch.full_like(pos_i, -1)), 0).values
    slot_in_run = pos_i - run_start
    newgrp = newrun | (slot_in_run % n_g == 0)
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    slot = slot_in_run % n_g
    over = gid >= G_B

    probe = torch.full((G_B + 1, 3), 1e6, dtype=torch.float32, device=dev)
    probe[torch.where(newgrp & ~over, gid, torch.full_like(gid, G_B))] = sp
    probe = probe[:G_B]
    nq = G_B * n_g * q
    ar_q = torch.arange(q, dtype=torch.int64, device=dev)
    qidx = (torch.where(over, torch.full_like(gid, nq), (gid * n_g + slot) * q)[:, None]
            + ar_q[None, :]).reshape(-1)
    gq = torch.zeros((nq + q, 3), dtype=torch.float32, device=dev)
    gq[qidx] = sq.reshape(-1, 3)
    gq = gq[:nq].reshape(G_B, n_g * q, 3)

    gidx_g, pos_g, valid_g = _probe_rank(lm, mc, offsets, probe, gq, k)

    src = torch.clamp(qidx, max=nq - 1)
    ov = over.repeat_interleave(q)
    g_i = torch.where(ov[:, None], torch.full((1, k), -1, dtype=gidx_g.dtype, device=dev),
                      gidx_g.reshape(nq, k)[src])
    p_i = torch.where(ov[:, None, None], torch.zeros((1, 1, 3), device=dev),
                      pos_g.reshape(nq, k, 3)[src])
    v_i = valid_g.reshape(nq, k)[src] & ~ov[:, None]
    gidx = torch.empty((N, q, k), dtype=gidx_g.dtype, device=dev)
    pos = torch.empty((N, q, k, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((N, q, k), dtype=torch.bool, device=dev)
    gidx[order] = g_i.view(N, q, k)
    pos[order] = p_i.view(N, q, k, 3)
    valid[order] = v_i.view(N, q, k)
    dropped = torch.empty((N,), dtype=torch.bool, device=dev)
    dropped[order] = over
    return torch.where(valid, gidx, torch.full_like(gidx, -1)), pos, valid, dropped


def append_knn(lm: npts.LocalMap, mc: npts.MapConfig, offsets, coords: torch.Tensor,
               ray_sample_count: int, near_count: int, far_offsets=None,
               per_neighbor_vecs: bool = False,
               dedup_far_budget: int = 0, quats: Optional[torch.Tensor] = None):
    """kNN + cached geometry of one frame's samples at append time: the
    first ``near_count`` samples of a ray rank within the ENDPOINT's probed
    ball, the free-space samples probe individually (optionally deduplicated
    by voxel).  coords (n_rays * S, 3) ray-major.  ``quats``: the global
    (cap+1, 4) quaternion column after a pose-graph optimisation (offset
    vectors rotated into each neighbour's frame), else None.

    Returns (gidx (M,k) int32 global ids, w (M,k), vec_blend (M,3),
    per-neighbour vectors (M,k,3) or None, dropped (M,))."""
    cells_t = offsets.cells if isinstance(offsets, npts.ProbeTemplate) else offsets
    k = min(mc.nn_k, cells_t.shape[0])
    Sn = ray_sample_count
    dev = coords.device
    n_rays = coords.shape[0] // Sn
    c3 = coords.reshape(n_rays, Sn, 3)
    near = c3[:, :near_count]
    far = c3[:, near_count:]

    g_near, p_near, v_near = _probe_rank(lm, mc, offsets, c3[:, 0], near, k)
    d_near = torch.zeros((n_rays,), dtype=torch.bool, device=dev)
    n_far = far.shape[1]
    if n_far > 0:
        far_flat = far.reshape(-1, 3)
        tmpl = offsets if far_offsets is None else far_offsets
        if dedup_far_budget > 0:
            g_far, p_far, v_far, d_far = dedup_group_probe(
                lm, mc, tmpl, far_flat, far_flat[:, None, :], k, dedup_far_budget, n_g=4)
        else:
            g_far, p_far, v_far = _probe_rank(lm, mc, tmpl, far_flat, far_flat[:, None, :], k)
            d_far = torch.zeros((far_flat.shape[0],), dtype=torch.bool, device=dev)
        g_far = g_far.reshape(n_rays, n_far, k)
        p_far = p_far.reshape(n_rays, n_far, k, 3)
        v_far = v_far.reshape(n_rays, n_far, k)
        d_far = d_far.reshape(n_rays, n_far)
        gidx = torch.cat([g_near, g_far], 1).reshape(-1, k)
        pos = torch.cat([p_near, p_far], 1).reshape(-1, k, 3)
        valid = torch.cat([v_near, v_far], 1).reshape(-1, k)
        dropped = torch.cat([d_near[:, None].expand(n_rays, near_count), d_far], 1).reshape(-1)
    else:
        gidx, pos, valid = g_near.reshape(-1, k), p_near.reshape(-1, k, 3), v_near.reshape(-1, k)
        dropped = d_near[:, None].expand(n_rays, near_count).reshape(-1)
    quat = None
    if quats is not None:
        g64 = gidx.to(torch.int64)
        cap = mc.capacity
        quat = quats[torch.where(g64 >= 0, torch.clamp(g64, max=cap), torch.full_like(g64, cap))]
    w, vec_blend, enc = idw_blend(coords, pos, valid, quat, return_per_neighbor=True)
    return gidx, w, vec_blend, (enc if per_neighbor_vecs else None), dropped


def pool_append(pool: PoolState, mcfg: MapperConfig, coord_world: torch.Tensor,
                coord_local: torch.Tensor, sdf_label: torch.Tensor, weight: torch.Tensor,
                valid: torch.Tensor, cur_ts: int, new_mask: torch.Tensor,
                knn_gidx: torch.Tensor, knn_w: torch.Tensor, knn_vec: torch.Tensor,
                knn_nbr_vec: Optional[torch.Tensor] = None) -> PoolState:
    """Ring-buffer append of one frame's valid samples as one contiguous
    block at the head (updates ``pool.rows`` in place)."""
    dev = coord_world.device
    P = mcfg.pool_capacity
    n = coord_world.shape[0]
    if n > P:
        raise ValueError(f"frame sample bucket {n} exceeds pool capacity {P}")
    head = torch.where(pool.head + n > P, torch.zeros_like(pool.head), pool.head)
    kk = knn_gidx.shape[1]
    built = torch.zeros((n, mcfg.pool_dim), dtype=torch.float32, device=dev)
    built[:, P_KNN] = -1.0
    built[:, P_COORD] = coord_world
    built[:, P_LABEL] = sdf_label
    built[:, P_WEIGHT] = weight
    built[:, P_TS] = float(cur_ts)
    built[:, P_LOCAL] = coord_local
    built[:, 9:9 + kk] = knn_gidx.to(torch.float32)
    built[:, 15:15 + kk] = knn_w
    built[:, P_VEC0:P_VEC0 + knn_vec.shape[1]] = knn_vec
    if knn_nbr_vec is not None:
        nv = knn_nbr_vec.reshape(n, -1)
        built[:, mcfg.pool_dim - nv.shape[1]:] = nv

    ar = torch.arange(n, dtype=torch.int64, device=dev)
    perm = torch.clamp(nonzero_static(valid, n, n), max=n - 1)
    n_valid = torch.sum(valid)
    in_valid = ar < n_valid
    new_rows = torch.where(in_valid[:, None], built[perm], torch.zeros_like(built))
    new_rows[:, P_TS] = torch.where(in_valid, new_rows[:, P_TS],
                                    torch.full_like(new_rows[:, P_TS], -1.0))
    new_rows[:, P_KNN] = torch.where(in_valid[:, None], new_rows[:, P_KNN],
                                     torch.full_like(new_rows[:, P_KNN], -1.0))
    pool.rows.index_copy_(0, head + ar, new_rows)

    new_head = head + n_valid
    nm_compact = in_valid & new_mask[perm]
    new_idx = nonzero_static(nm_compact, mcfg.new_idx_capacity, 0)
    return PoolState(rows=pool.rows, head=new_head % P,
                     fill=torch.clamp(torch.maximum(pool.fill, new_head), max=P),
                     new_idx=head + new_idx,
                     new_count=torch.clamp(torch.sum(nm_compact), max=mcfg.new_idx_capacity))


def pool_filter(pool: PoolState, mcfg: MapperConfig, origin: torch.Tensor) -> PoolState:
    """Window-radius compaction: drop samples outside ``window_radius`` of
    the sensor, compact the survivors to the front."""
    dev = pool.rows.device
    P = mcfg.pool_capacity
    in_fill = ((torch.arange(P + 1, dtype=torch.int64, device=dev) < pool.fill)
               & (pool.rows[:, P_TS] >= 0.0))
    d2 = sqnorm3(pool.rows[:, P_COORD] - origin)
    keep = in_fill & (d2 < mcfg.window_radius ** 2)
    perm = nonzero_static(keep, P + 1, P)
    count = torch.sum(keep)
    rows = pool.rows[perm]
    rows[P] = 0.0
    rows[P, P_KNN] = -1.0
    return PoolState(rows=rows, head=count % P, fill=count, new_idx=pool.new_idx,
                     new_count=torch.zeros_like(pool.new_count))


def pool_retransform(pool: PoolState, poses: torch.Tensor) -> PoolState:
    """Re-derive the world coordinates of every pool row from the per-frame
    poses (T,4,4) after a pose-graph optimisation (in place)."""
    T = poses[torch.clamp(pool.rows[:, P_TS].to(torch.int64), min=0)]
    coord = torch.einsum("nij,nj->ni", T[:, :3, :3], pool.rows[:, P_LOCAL]) + T[:, :3, 3]
    pool.rows[:, P_COORD] = coord
    return pool


REFRESH_CHUNK = 1 << 20


def pool_refresh_cache(pool: PoolState, state_attr_rows: torch.Tensor,
                       mc: npts.MapConfig) -> PoolState:
    """Recompute every pool row's cached kNN geometry (IDW weights, blended
    and per-neighbour offset vectors) from the current global positions and
    quaternions, keeping the cached neighbour sets (in place).  Rows are
    independent; they are processed ``REFRESH_CHUNK`` at a time so that the
    gathered neighbour rows ((P+1) x 6 x 16 floats, 3.2 GB at P = 2^23) are
    never held at once."""
    cap = mc.capacity
    n = pool.rows.shape[0]
    for a in range(0, n, REFRESH_CHUNK):
        rows_c = pool.rows[a:a + REFRESH_CHUNK]
        gidx = rows_c[:, P_KNN].to(torch.int64)
        safe = torch.where(gidx >= 0, torch.clamp(gidx, max=cap), torch.full_like(gidx, cap))
        nbr = state_attr_rows[safe]                                   # (c, k, 16)
        nbr_pos, quat = nbr[..., 0:3], nbr[..., 3:7]
        coord = rows_c[:, P_COORD]
        valid = (gidx >= 0) & (sqnorm3(nbr_pos - coord[:, None, :]) <= mc.max_valid_dist2)
        w, vec_blend, enc = idw_blend(coord, nbr_pos, valid, quat, return_per_neighbor=True)
        rows_c[:, P_W] = w
        vd = vec_blend.shape[-1]
        rows_c[:, P_VEC0:P_VEC0 + vd] = vec_blend
        if rows_c.shape[1] > P_VEC0 + vd:
            rows_c[:, P_VEC0 + vd:] = enc.reshape(enc.shape[0], -1)
    return pool


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """Adam moments of the two trained leaves: the (L+1, F+1) local feature
    table and the packed decoder vector."""
    count: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def init_opt_state(feats: torch.Tensor, gvec: torch.Tensor) -> AdamState:
    """Fresh Adam moments (re-initialized every frame, as in the JAX package)."""
    return AdamState(count=0, m=[torch.zeros_like(feats), torch.zeros_like(gvec)],
                     v=[torch.zeros_like(feats), torch.zeros_like(gvec)])


def adam_step(mcfg: MapperConfig, params: List[torch.Tensor], grads: List[torch.Tensor],
              st: AdamState) -> Tuple[List[torch.Tensor], AdamState]:
    """Adam(0.9, 0.99, eps) with the JAX package's update order, plain
    elementwise torch ops (bias corrections computed in float32)."""
    b1, b2, lr, eps = 0.9, 0.99, mcfg.lr, mcfg.adam_eps
    c = st.count + 1
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(c))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(c))
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, st.m, st.v):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        new_p.append(p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamState(count=c, m=new_m, v=new_v)


def sample_batch_indices(gen: torch.Generator, pool: PoolState, mcfg: MapperConfig,
                         use_new: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Mixed new/history batches for all iterations at once: the last
    n_new = min(new_count, bs_new) * use_new slots of each batch come from the
    new-region set, the rest uniform over the pool.  (num_iters, bs) int64."""
    dev = pool.rows.device
    T, B, Bn = num_iters, mcfg.bs, mcfg.bs_new_sample
    fill = torch.clamp(pool.fill, min=1)
    u_hist = torch.rand((T, B), generator=gen, device=dev, dtype=torch.float64)
    idx_hist = torch.minimum((u_hist * fill).to(torch.int64), fill - 1)
    cnt = torch.clamp(pool.new_count, min=1)
    u_new = torch.rand((T, Bn), generator=gen, device=dev, dtype=torch.float64)
    pick = torch.minimum((u_new * cnt).to(torch.int64), cnt - 1)
    idx_new = pool.new_idx[pick]
    n_new = torch.clamp(pool.new_count, max=Bn) * use_new.to(torch.int64)
    slot = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    take_new = slot >= (B - n_new)
    new_for_slot = torch.gather(idx_new, 1, torch.clamp(slot - (B - n_new), 0, Bn - 1)
                                .expand(T, B))
    return torch.where(take_new, new_for_slot, idx_hist)


def kernel_path_supported(mcfg: MapperConfig, cfg) -> bool:
    """Whether the port's training path covers this configuration: geometry
    head only, one hidden layer with biases, no feature layer-norm."""
    return (not cfg.semantic_on and not cfg.color_on and not cfg.layer_norm_on
            and cfg.geo_mlp_level == 1 and cfg.mlp_bias_on
            and (mcfg.bs // mcfg.gradient_decimation > 0 or not mcfg.ekional_loss_on))


def mapping_loop_cached(lm: npts.LocalMap, mc: npts.MapConfig, feats: torch.Tensor,
                        gvec: torch.Tensor, opt: AdamState, pool: PoolState,
                        mcfg: MapperConfig, batch_idx: torch.Tensor,
                        decoder_lr_scale: float, after_pgo: bool = False):
    """The per-frame training loop with pool-cached kNN (the kernel path).

    ``feats`` is the (L+1, F+1) local feature table whose column F is the
    certainty channel (kept at 0; the scatter of the kernels' dfeats delivers
    the per-point IDW weight sums there, harvested each iteration and kept
    out of Adam).  ``gvec`` is the packed decoder.  ``batch_idx`` (T, bs)
    pool rows per iteration (``sample_batch_indices``).  ``after_pgo``: the
    eikonal stencil's offset vectors are rotated by the neighbours'
    quaternions (the cached pool geometry already is).

    The pool rows and each iteration's feature rows come from the row-gather
    kernel; the feature gradients go back through the deterministic row
    scatter, summed from zero without a table (``scatter_sum_rows``), whose
    destination-sorted plans are built once for all T iterations.  Every invalid neighbour points at the sentinel row L: the
    scatter skips it (its gradient and certainty are never read: feats[L] is
    zeroed after every Adam step and attr[L] reset at the end).

    Returns (lm with updated certainty / ts bookkeeping, feats, gvec, opt,
    loss history (T,))."""
    dev = feats.device
    T, B = batch_idx.shape
    F = feats.shape[1] - 1
    L, cap, k = mc.local_capacity, mc.capacity, 6
    eik = mcfg.ekional_loss_on
    n_grad = B // mcfg.gradient_decimation if eik else 0
    VD = mcfg.vec_dim
    wf = mcfg.weighted_first

    flat_idx = batch_idx.reshape(-1)
    rows = rowk.gather_rows(pool.rows, flat_idx)
    labels = rows[:, P_LABEL].reshape(T, B).contiguous()
    weights = torch.abs(rows[:, P_WEIGHT]).reshape(T, B)
    ts_flat = rows[:, P_TS]
    in_pool = ((flat_idx < pool.fill) & (ts_flat >= 0.0)).reshape(T, B)
    gidx = rows[:, P_KNN].to(torch.int64)

    rank = torch.cumsum(lm.member_mask.to(torch.int64), 0) - 1
    local_of = torch.where(lm.member_mask, torch.clamp(rank, max=L), torch.full_like(rank, L))
    lidx = local_of[torch.where(gidx >= 0, torch.clamp(gidx, max=cap), torch.full_like(gidx, cap))]
    valid_k = (gidx >= 0) & (lidx < L)
    safe_g = torch.where(valid_k, lidx, torch.full_like(lidx, L))
    ts_proxy = torch.max(torch.where(in_pool, ts_flat.reshape(T, B), torch.zeros_like(labels)))

    w = torch.where(valid_k, rows[:, P_W], torch.zeros_like(rows[:, P_W])).reshape(T, B, k)
    if wf:
        vin = rows[:, P_VEC0:P_VEC0 + VD].reshape(T, B, VD).contiguous()
    else:
        vin = rows[:, P_VEC0 + VD:].reshape(T, B, k * VD).contiguous()
    safe_g = safe_g.reshape(T, B, k)

    inp_f = in_pool.to(torch.float32)
    denom = torch.clamp(torch.sum(inp_f, dim=1), min=1.0)
    wt_base = weights if mcfg.loss_weight_on else torch.ones_like(weights)
    wt_eff = wt_base * inp_f / denom[:, None]

    if eik:
        coord_r = rows.reshape(T, B, -1)[:, :n_grad, 0:3]
        eps_mat = torch.eye(3, dtype=torch.float32, device=dev) * mcfg.num_grad_step
        stencil = torch.cat([coord_r[:, None] + eps_mat[None, :, None, :],
                             coord_r[:, None] - eps_mat[None, :, None, :]], 1)  # (T,6,n,3)
        valid_b = valid_k.reshape(T, B, k)[:, :n_grad]
        pose_b = lm.attr_rows[safe_g[:, :n_grad]]                               # (T,n,k,16)
        quat_b = (pose_b[..., 3:7][:, None].expand(T, 6, n_grad, k, 4) if after_pgo
                  else None)
        w_st, vecb_st, enc_st = idw_blend(
            stencil, pose_b[..., :3][:, None].expand(T, 6, n_grad, k, 3),
            valid_b[:, None].expand(T, 6, n_grad, k), quat_b, return_per_neighbor=True)
        wst2 = w_st.reshape(T, 6 * n_grad, k).contiguous()
        vst = (vecb_st.reshape(T, 6 * n_grad, VD) if wf
               else enc_st.reshape(T, 6 * n_grad, k * VD)).contiguous()
        inp_e = inp_f[:, :n_grad]
        denom_e = torch.clamp(torch.sum(inp_e, dim=1), min=1.0)
        esc = mcfg.weight_e * inp_e / denom_e[:, None]

    # every iteration's scatter destinations: the B*k train rows, then the
    # n_grad*k eikonal base rows; range-checked once, sorted once
    idx_it = safe_g.reshape(T, B * k)
    if eik:
        idx_it = torch.cat([idx_it, safe_g[:, :n_grad].reshape(T, n_grad * k)], 1)
    plans = rowk.scatter_plans(idx_it, L + 1)

    cert_acc = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
    losses = []
    for t in range(T):
        feats2 = rowk.gather_rows(feats, idx_it[t, :B * k],
                                  bounds_checked=True).view(B, k, F + 1)
        loss, dfe, gp = train_kernel.train_iter(
            feats2, w[t], vin[t], labels[t], wt_eff[t], gvec, wf,
            mcfg.sdf_scale, mcfg.sigma_sigmoid)
        val_cat = dfe.reshape(-1, F + 1)
        if eik:
            el, dfe_e, gpe = train_kernel.eikonal_iter(
                feats2[:n_grad], wst2[t], vst[t], esc[t], gvec, wf,
                mcfg.sdf_scale, mcfg.num_grad_step)
            loss = loss + el
            gp = gp + gpe
            val_cat = torch.cat([val_cat, dfe_e.reshape(-1, F + 1)])
        gfeat = rowk.scatter_sum_rows(L + 1, idx_it[t], val_cat,
                                      plan=rowk.plan_at(plans, t), skip_row=L)
        cert_acc = cert_acc + gfeat[:, F]
        gfeat[:, F] = 0.0
        (feats, gvec), opt = adam_step(mcfg, [feats, gvec], [gfeat, decoder_lr_scale * gp], opt)
        feats[L] = 0.0
        losses.append(loss)

    touched = cert_acc > 0.0
    attr = lm.attr_rows.clone()
    attr[:, npts.C_CERT] = attr[:, npts.C_CERT] + cert_acc
    attr[:, npts.C_TSU] = torch.where(touched, torch.maximum(attr[:, npts.C_TSU], ts_proxy),
                                      attr[:, npts.C_TSU])
    attr[L] = npts.attr_sentinel_row(dev)
    lm_out = dataclasses.replace(lm, attr_rows=attr)
    return lm_out, feats, gvec, opt, torch.stack(losses)


def compute_new_sample_mask(lm: npts.LocalMap, mc: npts.MapConfig, mcfg: MapperConfig,
                            coord_world: torch.Tensor, sdf_label: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """Current-frame samples in newly observed regions: low certainty AND
    close to the surface."""
    cert = npts.query_certainty(lm, mc, coord_world)
    return (valid & (cert < mcfg.new_certainty_thre)
            & (torch.abs(sdf_label) < mcfg.surface_sample_range * 3.0))
