"""Incremental mapping, torch counterpart of ``pin_slam_tpu/slam/mapper.py``
(main-path, loop-closure, bundle-adjustment, colour and semantic subset):
the replay pool (with its colour or semantic labels), the append-time kNN
with its cached geometry, its re-derivation after a pose-graph
optimisation, the cached training loop on the kernel path (row gather ->
train/eikonal kernels -> deterministic row scatter -> Adam) with the colour
head's term beside it, the same loop by torch autograd for the
configurations the kernels do not cover (the semantic head, deeper or
bias-free SDF decoders; ``mapping_loop_autograd``), and sliding-window
bundle adjustment (torch autograd, with the feature gather and its
gradient on the row kernels).

Pool rows keep the JAX package's packed layout (``MapperConfig.p_*``):
sample coordinates, label, weight, frame id, sensor-frame coordinates, the
k = ``nn_k`` GLOBAL neighbour ids (value-cast float32, -1 = none), their
normalized IDW weights and the blended (encoded) offset vector (plus
per-neighbour vectors when ``weighted_first`` is False).  The layout is
sized from ``nn_k`` and ``vec_dim``; at k = 6 it is the JAX package's
column for column (whose fixed k = 6 layout a wider kNN overwrites,
ROADMAP C 2).

``mapping_loop`` is the JAX package's uncached loop (``PIN_SLAM_EXACT_KNN=1``):
a fresh kNN per batch, every head trained by autograd, feature layer-norm.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from pin_slam_torch.models import decoder as dec
from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.ops import losses, rank_kernel, rows as rowk, train_kernel
from pin_slam_torch.ops.encodings import encoded_dim
from pin_slam_torch.ops.hash3d import div_f32, grid_coords
from pin_slam_torch.ops.scatter import nonzero_static
from pin_slam_torch.ops.transforms import apply_quaternion_rotation, se3_expmap
from pin_slam_torch.ops.voxel import sqnorm3


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
    color_on: bool = False
    weight_i: float = 1.0
    semantic_on: bool = False
    weight_s: float = 1.0
    nn_k: int = 6

    @property
    def p_knn(self) -> slice:
        return pool_layout(self.nn_k)[0]

    @property
    def p_w(self) -> slice:
        return pool_layout(self.nn_k)[1]

    @property
    def p_vec0(self) -> int:
        return pool_layout(self.nn_k)[2]

    @property
    def pool_dim(self) -> int:
        return self.p_vec0 + self.vec_dim * (1 if self.weighted_first else 1 + self.nn_k)

    @staticmethod
    def from_config(cfg) -> "MapperConfig":
        return MapperConfig(
            vec_dim=encoded_dim(cfg.pos_input_dim, cfg.pos_encoding_band, cfg.use_gaussian_pe),
            nn_k=int(cfg.query_nn_k),
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
            new_certainty_thre=cfg.new_certainty_thre,
            color_on=cfg.color_on, weight_i=cfg.weight_i,
            semantic_on=cfg.semantic_on, weight_s=cfg.weight_s)


P_COORD = slice(0, 3)
P_LABEL = 3
P_WEIGHT = 4
P_TS = 5
P_LOCAL = slice(6, 9)


def pool_layout(k: int) -> Tuple[slice, slice, int]:
    """(neighbour-id columns, IDW-weight columns, first offset-vector column)
    of pool rows holding k neighbours: after the sample's coordinates,
    label, weight, frame id and sensor-frame coordinates (P_COORD ..
    P_LOCAL) come the k GLOBAL neighbour ids, their k IDW weights, then the
    blended (encoded) offset vector (vec_dim), and with weighted_first
    False the k per-neighbour vectors."""
    return slice(9, 9 + k), slice(9 + k, 9 + 2 * k), 9 + 2 * k


# the k = 6 layout, the JAX package's
P_KNN, P_W, P_VEC0 = pool_layout(6)


@dataclasses.dataclass
class PoolState:
    """Replay pool, fixed capacity P (P+1 rows, last = padding)."""
    rows: torch.Tensor       # (P+1, pool_dim) f32
    head: torch.Tensor       # () int64 ring write position
    fill: torch.Tensor       # () int64 valid entries
    new_idx: torch.Tensor    # (N_new,) int64 pool indices of new-region samples
    new_count: torch.Tensor  # () int64
    color_label: Optional[torch.Tensor] = None   # (P+1, C) f32 with color_on; its
    #                                              own array, so the rows keep their width
    sem_label: Optional[torch.Tensor] = None     # (P+1,) int32 with semantic_on


def init_pool(mcfg: MapperConfig, device=None, color_channel: int = 3) -> PoolState:
    P = mcfg.pool_capacity
    rows = torch.zeros((P + 1, mcfg.pool_dim), dtype=torch.float32, device=device)
    rows[:, mcfg.p_knn] = -1.0
    z = torch.zeros((), dtype=torch.int64, device=device)
    return PoolState(rows=rows, head=z.clone(), fill=z.clone(),
                     new_idx=torch.zeros((mcfg.new_idx_capacity,), dtype=torch.int64,
                                         device=device),
                     new_count=z.clone(),
                     color_label=(torch.zeros((P + 1, color_channel), dtype=torch.float32,
                                              device=device) if mcfg.color_on else None),
                     sem_label=(torch.zeros((P + 1,), dtype=torch.int32, device=device)
                                if mcfg.semantic_on else None))


def pool_from_numpy(src, device=None) -> PoolState:
    """A JAX ``PoolState`` (or any object with its array attributes) -> PoolState."""
    def t(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)
    col = getattr(src, "color_label", None)
    sem = getattr(src, "sem_label", None)
    return PoolState(rows=t(src.rows, torch.float32), head=t(src.head, torch.int64),
                     fill=t(src.fill, torch.int64), new_idx=t(src.new_idx, torch.int64),
                     new_count=t(src.new_count, torch.int64),
                     color_label=t(col, torch.float32) if col is not None else None,
                     sem_label=t(sem, torch.int32) if sem is not None else None)


def idw_blend(points: torch.Tensor, nbr_pos: torch.Tensor, valid: torch.Tensor,
              quat: Optional[torch.Tensor] = None, return_per_neighbor: bool = False,
              pos_encode=None):
    """Normalized IDW weights + weight-blended (encoded) offset vector at
    fixed neighbour positions.  points (...,3), nbr_pos (...,k,3), valid
    (...,k), quat (...,k,4) or None: each offset vector rotated into its
    neighbour's frame (identity until a pose-graph optimisation deforms the
    map); ``pos_encode`` (``MapConfig.pos_encode``) encodes the masked
    vectors before the blend.  With ``return_per_neighbor`` the (encoded)
    per-neighbour vectors come third."""
    vec = points[..., None, :] - nbr_pos
    dist2 = torch.where(valid, sqnorm3(vec), torch.full_like(vec[..., 0], npts._INVALID_DIST2))
    if quat is not None:
        vec = apply_quaternion_rotation(quat, vec)
    vec = torch.where(valid[..., None], vec, torch.zeros_like(vec))
    _, _, w = npts.idw_weights(dist2, valid, 1e-15)
    if pos_encode is not None:
        vec = pos_encode(vec)
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
               dedup_far_budget: int = 0, quats: Optional[torch.Tensor] = None,
               pos_encode=None):
    """kNN + cached geometry of one frame's samples at append time: the
    first ``near_count`` samples of a ray rank within the ENDPOINT's probed
    ball, the free-space samples probe individually (optionally deduplicated
    by voxel).  coords (n_rays * S, 3) ray-major.  ``quats``: the global
    (cap+1, 4) quaternion column after a pose-graph optimisation (offset
    vectors rotated into each neighbour's frame), else None.  ``pos_encode``
    encodes the offset vectors (``MapConfig.pos_encode``).

    Returns (gidx (M,k) int32 global ids, w (M,k), vec_blend (M,VD),
    per-neighbour vectors (M,k,VD) or None, dropped (M,))."""
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
    w, vec_blend, enc = idw_blend(coords, pos, valid, quat, return_per_neighbor=True,
                                  pos_encode=pos_encode)
    return gidx, w, vec_blend, (enc if per_neighbor_vecs else None), dropped


def pool_append(pool: PoolState, mcfg: MapperConfig, coord_world: torch.Tensor,
                coord_local: torch.Tensor, sdf_label: torch.Tensor, weight: torch.Tensor,
                valid: torch.Tensor, cur_ts: int, new_mask: torch.Tensor,
                knn_gidx: torch.Tensor, knn_w: torch.Tensor, knn_vec: torch.Tensor,
                knn_nbr_vec: Optional[torch.Tensor] = None,
                color_label: Optional[torch.Tensor] = None,
                sem_label: Optional[torch.Tensor] = None) -> PoolState:
    """Ring-buffer append of one frame's valid samples as one contiguous
    block at the head (updates ``pool.rows``, and ``pool.color_label`` /
    ``pool.sem_label`` with the samples' ``color_label`` (n, C) /
    ``sem_label`` (n,) in the same order, in place).  ``knn_gidx`` /
    ``knn_w`` (n, k) fill the layout's k neighbour and weight columns (k at
    most ``mcfg.nn_k``; -1 ids past k), ``knn_vec`` (n, VD) the blended
    vector and ``knn_nbr_vec`` (n, k, VD) the per-neighbour ones."""
    dev = coord_world.device
    P = mcfg.pool_capacity
    n = coord_world.shape[0]
    if n > P:
        raise ValueError(f"frame sample bucket {n} exceeds pool capacity {P}")
    head = torch.where(pool.head + n > P, torch.zeros_like(pool.head), pool.head)
    kk = knn_gidx.shape[1]
    if kk > mcfg.nn_k:
        raise ValueError(f"{kk} neighbours for a pool laid out for {mcfg.nn_k}")
    p_knn, p_w, p_vec0 = mcfg.p_knn, mcfg.p_w, mcfg.p_vec0
    built = torch.zeros((n, mcfg.pool_dim), dtype=torch.float32, device=dev)
    built[:, p_knn] = -1.0
    built[:, P_COORD] = coord_world
    built[:, P_LABEL] = sdf_label
    built[:, P_WEIGHT] = weight
    built[:, P_TS] = float(cur_ts)
    built[:, P_LOCAL] = coord_local
    built[:, p_knn.start:p_knn.start + kk] = knn_gidx.to(torch.float32)
    built[:, p_w.start:p_w.start + kk] = knn_w
    built[:, p_vec0:p_vec0 + knn_vec.shape[1]] = knn_vec
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
    new_rows[:, p_knn] = torch.where(in_valid[:, None], new_rows[:, p_knn],
                                     torch.full_like(new_rows[:, p_knn], -1.0))
    pool.rows.index_copy_(0, head + ar, new_rows)
    if pool.color_label is not None:
        pool.color_label.index_copy_(0, head + ar,
                                     color_label[perm] * in_valid[:, None].to(torch.float32))
    if pool.sem_label is not None:
        pool.sem_label.index_copy_(0, head + ar,
                                   sem_label.to(torch.int32)[perm] * in_valid.to(torch.int32))

    new_head = head + n_valid
    nm_compact = in_valid & new_mask[perm]
    new_idx = nonzero_static(nm_compact, mcfg.new_idx_capacity, 0)
    return PoolState(rows=pool.rows, head=new_head % P,
                     fill=torch.clamp(torch.maximum(pool.fill, new_head), max=P),
                     new_idx=head + new_idx,
                     new_count=torch.clamp(torch.sum(nm_compact), max=mcfg.new_idx_capacity),
                     color_label=pool.color_label, sem_label=pool.sem_label)


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
    rows[P, mcfg.p_knn] = -1.0
    return PoolState(rows=rows, head=count % P, fill=count, new_idx=pool.new_idx,
                     new_count=torch.zeros_like(pool.new_count),
                     color_label=(pool.color_label[perm] if pool.color_label is not None
                                  else None),
                     sem_label=pool.sem_label[perm] if pool.sem_label is not None else None)


def pool_retransform(pool: PoolState, poses: torch.Tensor) -> PoolState:
    """Re-derive the world coordinates of every pool row from the per-frame
    poses (T,4,4) after a pose-graph optimisation (in place)."""
    T = poses[torch.clamp(pool.rows[:, P_TS].to(torch.int64), min=0)]
    coord = torch.einsum("nij,nj->ni", T[:, :3, :3], pool.rows[:, P_LOCAL]) + T[:, :3, 3]
    pool.rows[:, P_COORD] = coord
    return pool


REFRESH_CHUNK = 1 << 20


def pool_refresh_cache(pool: PoolState, state_attr_rows: torch.Tensor,
                       mc: npts.MapConfig, pos_encode=None) -> PoolState:
    """Recompute every pool row's cached kNN geometry (IDW weights, blended
    and per-neighbour (encoded, with ``pos_encode``) offset vectors) from the
    current global positions and quaternions, keeping the cached neighbour
    sets (in place; the layout's k is ``mc.nn_k``).  Rows are independent;
    they are processed ``REFRESH_CHUNK`` at a time so that the gathered
    neighbour rows ((P+1) x k x 16 floats, 3.2 GB at P = 2^23, k = 6) are
    never held at once."""
    cap = mc.capacity
    p_knn, p_w, p_vec0 = pool_layout(mc.nn_k)
    n = pool.rows.shape[0]
    for a in range(0, n, REFRESH_CHUNK):
        rows_c = pool.rows[a:a + REFRESH_CHUNK]
        gidx = rows_c[:, p_knn].to(torch.int64)
        safe = torch.where(gidx >= 0, torch.clamp(gidx, max=cap), torch.full_like(gidx, cap))
        nbr = state_attr_rows[safe]                                   # (c, k, 16)
        nbr_pos, quat = nbr[..., 0:3], nbr[..., 3:7]
        coord = rows_c[:, P_COORD]
        valid = (gidx >= 0) & (sqnorm3(nbr_pos - coord[:, None, :]) <= mc.max_valid_dist2)
        w, vec_blend, enc = idw_blend(coord, nbr_pos, valid, quat, return_per_neighbor=True,
                                      pos_encode=pos_encode)
        rows_c[:, p_w] = w
        vd = vec_blend.shape[-1]
        rows_c[:, p_vec0:p_vec0 + vd] = vec_blend
        if rows_c.shape[1] > p_vec0 + vd:
            rows_c[:, p_vec0 + vd:] = enc.reshape(enc.shape[0], -1)
    return pool


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------


@dataclasses.dataclass
class AdamState:
    """Adam moments of the trained leaves: the (L+1, F+1) local feature
    table, then the packed decoder vector (the kernel path) or every decoder
    leaf (the autograd loop)."""
    count: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def init_opt_state(feats: torch.Tensor, params) -> AdamState:
    """Fresh Adam moments (re-initialized every frame, as in the JAX package)
    of the feature table and the decoder leaves: the packed decoder vector
    (the kernel path) or a ``Heads`` (the autograd loop)."""
    leaves = [feats] + (params.leaves() if isinstance(params, Heads) else [params])
    return AdamState(count=0, m=[torch.zeros_like(x) for x in leaves],
                     v=[torch.zeros_like(x) for x in leaves])


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


@dataclasses.dataclass
class ColorState:
    """The colour head's trained leaves: the (L+1, F) local colour feature
    table and the values of the colour decoder's parameters (in the order
    of ``decoder.parameters()``), with their Adam moments, threaded through
    a frame's training calls like the geometry's (``mapping_loop_cached``
    replaces ``features``, ``params`` and ``opt``).  ``decoder`` gives the
    head's structure; its own parameters are not read."""
    decoder: torch.nn.Module
    features: torch.Tensor
    params: List[torch.Tensor]
    opt: AdamState

    def leaves(self) -> List[torch.Tensor]:
        return [self.features] + self.params

    def load_into(self, decoder: torch.nn.Module) -> None:
        """Copy the trained parameter values into ``decoder``."""
        with torch.no_grad():
            for p, v in zip(decoder.parameters(), self.params):
                p.copy_(v)


def init_color_state(features: torch.Tensor, decoder: torch.nn.Module) -> ColorState:
    """The colour leaves of a training call with fresh Adam moments."""
    params = [p.detach().clone() for p in decoder.parameters()]
    leaves = [features] + params
    return ColorState(decoder=decoder, features=features, params=params,
                      opt=AdamState(count=0, m=[torch.zeros_like(x) for x in leaves],
                                    v=[torch.zeros_like(x) for x in leaves]))


def color_loss_and_grads(color: ColorState, cfeats: torch.Tensor, w: torch.Tensor,
                         vin: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
                         surf: torch.Tensor, mcfg: MapperConfig):
    """The colour term of one iteration, ``weight_i`` x the L1 colour loss
    of the surface samples, and its gradients in the gathered colour rows
    ``cfeats`` (B, k, F) and in the colour decoder's parameters (torch
    autograd over this small graph; the rows are a leaf, so nothing is
    scattered here).  ``vin``: the blended offset vectors (B, 3) with
    ``weighted_first`` (blend the features, decode once), else the
    per-neighbour ones (B, k, 3) (decode each neighbour, blend the colours).
    Returns (loss, d loss / d cfeats, [d loss / d param])."""
    names = [n for n, _ in color.decoder.named_parameters()]
    with torch.enable_grad():
        cf = cfeats.detach().requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in color.params]

        def head(x):
            out = torch.func.functional_call(color.decoder, dict(zip(names, ps)), (x,))
            return dec.clip01(out)

        if mcfg.weighted_first:
            pred = head(torch.cat([torch.einsum("bk,bkf->bf", w, cf), vin], -1))
        else:
            pred = torch.einsum("bk,bkc->bc", w, head(torch.cat([cf, vin], -1)))
        loss = mcfg.weight_i * losses.color_diff_loss(pred, label, weight, mcfg.loss_weight_on,
                                                      valid=surf)
        grads = torch.autograd.grad(loss, [cf] + ps)
    return loss.detach(), grads[0], list(grads[1:])


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
    """Whether the training kernels cover this configuration: the geometry
    head (one hidden layer with biases) on the kernels, the colour head
    beside them; no semantic head, no feature layer-norm; feature, hidden
    and offset widths and k that ``train_kernel.kernels_take`` accepts.
    Every other configuration trains by ``mapping_loop_autograd``, as the
    JAX package trains by autodiff what its kernels do not cover; a width
    past the kernels' is logged."""
    if not (not cfg.semantic_on and not cfg.layer_norm_on
            and cfg.geo_mlp_level == 1 and cfg.mlp_bias_on
            and (mcfg.bs // mcfg.gradient_decimation > 0 or not mcfg.ekional_loss_on)):
        return False
    widths = (int(cfg.feature_dim), int(cfg.geo_mlp_hidden_dim), mcfg.vec_dim, mcfg.nn_k)
    if not train_kernel.kernels_take(*widths):
        print(f"[mapper] feature_dim {widths[0]}, mlp_hidden_dim {widths[1]}, offset width "
              f"{widths[2]}, k {widths[3]}: past the training kernels' widths "
              f"(train_kernel.kernels_take); training by mapping_loop_autograd", flush=True)
        return False
    return True


@dataclasses.dataclass
class _Batches:
    """Every iteration's batch of one training call, read from the pool at
    once: (T, B) labels, |weights|, in-pool flags; (T, B, k) local neighbour
    rows (L where invalid) and IDW weights (0 where invalid); the offset
    vectors ``vin``, blended (T, B, VD) with ``weighted_first``, else per
    neighbour (T, B, k * VD); the newest frame id sampled; and with the
    eikonal term the stencil's weights (T, 6 n, k) and offset vectors
    (T, 6 n, VD or k * VD) of the first n = B / gradient_decimation rows."""
    flat_idx: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor
    in_pool: torch.Tensor
    safe_g: torch.Tensor
    w: torch.Tensor
    vin: torch.Tensor
    ts_proxy: torch.Tensor
    n_grad: int
    wst2: Optional[torch.Tensor] = None
    vst: Optional[torch.Tensor] = None

    def step(self, t: int, wf: bool, sem_lab: Optional[torch.Tensor] = None,
             col_lab: Optional[torch.Tensor] = None) -> "_Step":
        """Iteration t's inputs to ``autograd_loss_and_grads``."""
        B, k = self.safe_g.shape[1], self.safe_g.shape[2]
        n = self.n_grad
        st = _Step(gidx=self.safe_g[t], w=self.w[t],
                   vin=self.vin[t] if wf else self.vin[t].reshape(B, k, -1),
                   labels=self.labels[t], weights=self.weights[t], in_pool=self.in_pool[t],
                   sem_lab=None if sem_lab is None else sem_lab[t],
                   col_lab=None if col_lab is None else col_lab[t])
        if n:
            st.wst = self.wst2[t].reshape(6, n, k)
            st.vst = self.vst[t].reshape(6, n, -1) if wf else self.vst[t].reshape(6, n, k, -1)
        return st


@dataclasses.dataclass
class _Step:
    """One iteration's batch for ``autograd_loss_and_grads``, from the pool
    cache (``_Batches.step``) or a fresh kNN (``mapping_loop``): (B, k) local
    neighbour rows (L where invalid) and IDW weights; the (encoded) offset
    vectors, blended (B, VD) with ``weighted_first``, else (B, k, VD); (B,)
    labels, |weights|, in-pool flags; with the eikonal term the stencil's
    weights (6, n, k) and offset vectors (6, n, VD) or (6, n, k, VD) of the
    first n rows; the semantic classes (B,) and colour labels (B, 3) where
    a head reads them."""
    gidx: torch.Tensor
    w: torch.Tensor
    vin: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor
    in_pool: torch.Tensor
    wst: Optional[torch.Tensor] = None
    vst: Optional[torch.Tensor] = None
    sem_lab: Optional[torch.Tensor] = None
    col_lab: Optional[torch.Tensor] = None


def _read_batches(lm: npts.LocalMap, mc: npts.MapConfig, pool: PoolState, mcfg: MapperConfig,
                  batch_idx: torch.Tensor, after_pgo: bool, mesh=None) -> _Batches:
    """The pool rows of ``batch_idx`` (T, B) (one gather-kernel launch),
    their cached neighbours remapped to local rows, and the eikonal
    stencil's geometry (offset vectors rotated by the neighbours'
    quaternions ``after_pgo``).  With ``mesh`` the newest frame id sampled
    is the maximum over its ranks."""
    if mesh is not None:
        from pin_slam_torch.parallel import mesh as pmesh
    dev = pool.rows.device
    T, B = batch_idx.shape
    L, cap, k = mc.local_capacity, mc.capacity, mcfg.nn_k
    n_grad = B // mcfg.gradient_decimation if mcfg.ekional_loss_on else 0
    VD = mcfg.vec_dim
    wf = mcfg.weighted_first

    flat_idx = batch_idx.reshape(-1)
    rows = rowk.gather_rows(pool.rows, flat_idx)
    labels = rows[:, P_LABEL].reshape(T, B).contiguous()
    weights = torch.abs(rows[:, P_WEIGHT]).reshape(T, B)
    ts_flat = rows[:, P_TS]
    in_pool = ((flat_idx < pool.fill) & (ts_flat >= 0.0)).reshape(T, B)
    gidx = rows[:, mcfg.p_knn].to(torch.int64)

    rank = torch.cumsum(lm.member_mask.to(torch.int64), 0) - 1
    local_of = torch.where(lm.member_mask, torch.clamp(rank, max=L), torch.full_like(rank, L))
    lidx = local_of[torch.where(gidx >= 0, torch.clamp(gidx, max=cap), torch.full_like(gidx, cap))]
    valid_k = (gidx >= 0) & (lidx < L)
    safe_g = torch.where(valid_k, lidx, torch.full_like(lidx, L))
    ts_proxy = torch.max(torch.where(in_pool, ts_flat.reshape(T, B), torch.zeros_like(labels)))
    if mesh is not None:
        ts_proxy = pmesh.pmax(mesh, ts_proxy)

    p_w, p_vec0 = mcfg.p_w, mcfg.p_vec0
    w = torch.where(valid_k, rows[:, p_w], torch.zeros_like(rows[:, p_w])).reshape(T, B, k)
    if wf:
        vin = rows[:, p_vec0:p_vec0 + VD].reshape(T, B, VD).contiguous()
    else:
        vin = rows[:, p_vec0 + VD:].reshape(T, B, k * VD).contiguous()
    safe_g = safe_g.reshape(T, B, k)
    out = _Batches(flat_idx=flat_idx, labels=labels, weights=weights, in_pool=in_pool,
                   safe_g=safe_g, w=w, vin=vin, ts_proxy=ts_proxy, n_grad=n_grad)
    if n_grad:
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
            valid_b[:, None].expand(T, 6, n_grad, k), quat_b, return_per_neighbor=True,
            pos_encode=mc.pos_encode)
        out.wst2 = w_st.reshape(T, 6 * n_grad, k).contiguous()
        out.vst = (vecb_st.reshape(T, 6 * n_grad, VD) if wf
                   else enc_st.reshape(T, 6 * n_grad, k * VD)).contiguous()
    return out


def _fold_certainty(lm: npts.LocalMap, cert_acc: torch.Tensor,
                    ts_proxy: torch.Tensor) -> npts.LocalMap:
    """The local map with a training call's certainty sums added and the
    touched points' update stamp raised to the newest frame sampled."""
    L = lm.attr_rows.shape[0] - 1
    touched = cert_acc > 0.0
    attr = lm.attr_rows.clone()
    attr[:, npts.C_CERT] = attr[:, npts.C_CERT] + cert_acc
    attr[:, npts.C_TSU] = torch.where(touched, torch.maximum(attr[:, npts.C_TSU], ts_proxy),
                                      attr[:, npts.C_TSU])
    attr[L] = npts.attr_sentinel_row(attr.device)
    return dataclasses.replace(lm, attr_rows=attr)


def mapping_loop_cached(lm: npts.LocalMap, mc: npts.MapConfig, feats: torch.Tensor,
                        gvec: torch.Tensor, opt: AdamState, pool: PoolState,
                        mcfg: MapperConfig, batch_idx: torch.Tensor,
                        decoder_lr_scale: float, after_pgo: bool = False,
                        color: Optional[ColorState] = None, mesh=None):
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

    With ``color`` (and ``pool.color_label``) each iteration adds the colour
    head's term (``color_loss_and_grads``) at the same cached neighbours and
    weights: the colour rows come from the gather kernel, and their gradient
    goes back through the same scatter plan as the geometry's (zero rows
    stand in for the eikonal part), summed in index order.  The geometry and
    colour terms share no parameter and Adam works element by element, so
    the colour leaves take their own Adam step; ``color`` is updated in
    place and the loss history holds both terms.

    With ``mesh`` (a ``parallel.mesh.Mesh``; the JAX package's
    ``axis_name``) the loop runs data-parallel: ``batch_idx`` is this rank's
    batch, and before every Adam step the feature, decoder and colour
    gradients and the loss are averaged over the ranks and the certainty
    sums summed (one all-reduce for the geometry, one for the colour head);
    the newest frame id sampled is the maximum over the ranks.  Every rank
    then takes the same Adam step.

    Returns (lm with updated certainty / ts bookkeeping, feats, gvec, opt,
    loss history (T,))."""
    if mesh is not None:
        from pin_slam_torch.parallel import mesh as pmesh
    dev = feats.device
    T, B = batch_idx.shape
    F = feats.shape[1] - 1
    L, k = mc.local_capacity, mcfg.nn_k
    wf = mcfg.weighted_first
    bt = _read_batches(lm, mc, pool, mcfg, batch_idx, after_pgo, mesh)
    n_grad, eik = bt.n_grad, mcfg.ekional_loss_on
    safe_g, w, vin, labels, weights = bt.safe_g, bt.w, bt.vin, bt.labels, bt.weights

    inp_f = bt.in_pool.to(torch.float32)
    denom = torch.clamp(torch.sum(inp_f, dim=1), min=1.0)
    wt_base = weights if mcfg.loss_weight_on else torch.ones_like(weights)
    wt_eff = wt_base * inp_f / denom[:, None]
    if color is not None:
        col_lab = rowk.gather_rows(pool.color_label, bt.flat_idx).reshape(T, B, -1)
        col_surf = bt.in_pool & (torch.abs(labels) < mcfg.surface_sample_range)
        col_vin = vin if wf else vin.reshape(T, B, k, mcfg.vec_dim)
    if eik:
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
    hist = []
    for t in range(T):
        feats2 = rowk.gather_rows(feats, idx_it[t, :B * k],
                                  bounds_checked=True).view(B, k, F + 1)
        loss, dfe, gp = train_kernel.train_iter(
            feats2, w[t], vin[t], labels[t], wt_eff[t], gvec, wf,
            mcfg.sdf_scale, mcfg.sigma_sigmoid)
        val_cat = dfe.reshape(-1, F + 1)
        if eik:
            el, dfe_e, gpe = train_kernel.eikonal_iter(
                feats2[:n_grad], bt.wst2[t], bt.vst[t], esc[t], gvec, wf,
                mcfg.sdf_scale, mcfg.num_grad_step)
            loss = loss + el
            gp = gp + gpe
            val_cat = torch.cat([val_cat, dfe_e.reshape(-1, F + 1)])
        gfeat = rowk.scatter_sum_rows(L + 1, idx_it[t], val_cat,
                                      plan=rowk.plan_at(plans, t), skip_row=L)
        if mesh is not None:
            (gp, loss), (gfeat,) = pmesh.reduce_grads(mesh, [gp, loss], [gfeat])
            cert_acc = cert_acc + gfeat[:, F]
            gfeat = gfeat / mesh.size
        else:
            cert_acc = cert_acc + gfeat[:, F]
        gfeat[:, F] = 0.0
        (feats, gvec), opt = adam_step(mcfg, [feats, gvec], [gfeat, decoder_lr_scale * gp], opt)
        feats[L] = 0.0
        if color is not None:
            cf = rowk.gather_rows(color.features, idx_it[t, :B * k],
                                  bounds_checked=True).view(B, k, -1)
            loss_c, g_cf, g_dec = color_loss_and_grads(
                color, cf, w[t], col_vin[t], col_lab[t], weights[t], col_surf[t], mcfg)
            g_rows = g_cf.reshape(B * k, -1)
            if eik:
                g_rows = torch.cat([g_rows, g_rows.new_zeros((n_grad * k, g_rows.shape[1]))])
            gcol = rowk.scatter_sum_rows(L + 1, idx_it[t], g_rows,
                                         plan=rowk.plan_at(plans, t), skip_row=L)
            if mesh is not None:
                (gcol, loss_c, *g_dec), _ = pmesh.reduce_grads(mesh, [gcol, loss_c] + g_dec)
            loss = loss + loss_c
            new, color.opt = adam_step(mcfg, color.leaves(),
                                       [gcol] + [decoder_lr_scale * g for g in g_dec],
                                       color.opt)
            color.features, color.params = new[0], new[1:]
        hist.append(loss)
    return _fold_certainty(lm, cert_acc, bt.ts_proxy), feats, gvec, opt, torch.stack(hist)


@dataclasses.dataclass
class Heads:
    """The decoders the autograd loop trains: the SDF decoder and, with a
    semantic head, the semantic decoder, each given by its structure (a
    ``Decoder``, whose own parameters are not read) and the values of its
    parameters in the order of ``decoder.parameters()``.  Threaded through a
    frame's training calls as the packed vector is on the kernel path."""
    geo: torch.nn.Module
    geo_params: List[torch.Tensor]
    sem: Optional[torch.nn.Module] = None
    sem_params: List[torch.Tensor] = dataclasses.field(default_factory=list)

    def leaves(self) -> List[torch.Tensor]:
        return self.geo_params + self.sem_params

    def with_leaves(self, leaves: List[torch.Tensor]) -> "Heads":
        n = len(self.geo_params)
        return dataclasses.replace(self, geo_params=list(leaves[:n]),
                                   sem_params=list(leaves[n:]))

    def load_into(self, geo: torch.nn.Module, sem: Optional[torch.nn.Module] = None) -> None:
        """Copy the trained values into ``geo`` (and ``sem``)."""
        with torch.no_grad():
            for dst, vals in ((geo, self.geo_params), (sem, self.sem_params)):
                if dst is not None:
                    for p, v in zip(dst.parameters(), vals):
                        p.copy_(v)


def init_heads(geo: torch.nn.Module, sem: Optional[torch.nn.Module] = None) -> Heads:
    """The autograd loop's decoder leaves, copied from ``geo`` and ``sem``."""
    return Heads(geo=geo, geo_params=[p.detach().clone() for p in geo.parameters()], sem=sem,
                 sem_params=[p.detach().clone() for p in sem.parameters()] if sem is not None
                 else [])


def _functional(module: torch.nn.Module, params: List[torch.Tensor]):
    """``module``'s forward with ``params`` in place of its own parameters."""
    names = [n for n, _ in module.named_parameters()]
    return lambda x: torch.func.functional_call(module, dict(zip(names, params)), (x,))


def autograd_loss_and_grads(feats: torch.Tensor, heads: Heads, st: _Step,
                            mcfg: MapperConfig, plan: rowk.ScatterPlan,
                            certainty: bool = True, layer_norm: bool = False,
                            color: Optional[ColorState] = None):
    """One iteration's loss of the autograd loops, the JAX package's
    ``mapping_loop_cached`` body without its kernels and its uncached
    ``mapping_loop`` body: the IDW-blended SDF (blend then decode with
    ``weighted_first``, else decode each neighbour and blend), BCE against
    the labels, the eikonal term at the stencil, with a semantic head the
    weighted NLL of the surface samples' classes (log-probabilities blended
    per neighbour unless ``weighted_first``), and with ``color`` the colour
    head's L1 term at the surface samples.  The feature rows come through
    ``rows.GatherRowsFn`` (the gather kernel, and for their gradient the
    in-order scatter with ``plan``; row L gets none), masked where the
    neighbour is invalid and layer-normed with ``layer_norm``; no other
    indexed operation is in the graph.  With ``certainty`` the table's last
    column is the certainty channel, whose gradient is the term sum(w *
    feats[..., F]).  Returns (loss without the certainty term, d / d feats,
    [d / d head leaf], [d / d colour leaf] or None)."""
    L = feats.shape[0] - 1
    F = feats.shape[1] - int(certainty)
    k = st.gidx.shape[1]
    n = 0 if st.wst is None else st.wst.shape[1]
    wf = mcfg.weighted_first
    w = st.w
    valid = st.gidx < L
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in heads.leaves()]
        hs = heads.with_leaves(ps)
        geo = _functional(hs.geo, hs.geo_params)

        def sdf(x):
            return geo(x)[..., 0] * mcfg.sdf_scale

        def read(tab):                                                   # (B, k, C)
            r = rowk.GatherRowsFn.apply(tab, st.gidx, L, plan)
            return torch.where(valid[..., None], r, torch.zeros_like(r))

        rows = read(f)
        fk = npts.layer_norm(rows[..., :F]) if layer_norm else rows[..., :F]
        if wf:
            geo_feat = torch.cat([torch.einsum("bk,bkf->bf", w, fk), st.vin], -1)
            sdf_pred = sdf(geo_feat)
        else:
            per_in = torch.cat([fk, st.vin], -1)
            sdf_pred = torch.sum(sdf(per_in) * w, dim=-1)
        loss = losses.sdf_bce_loss(sdf_pred, st.labels, mcfg.sigma_sigmoid, st.weights,
                                   mcfg.loss_weight_on, valid=st.in_pool)
        cert_term = torch.sum(w * rows[..., F]) if certainty else 0.0
        if n:
            if wf:
                st_feat = torch.einsum("jnk,nkf->jnf", st.wst, fk[:n])
                sdf_st = sdf(torch.cat([st_feat, st.vst], -1))                   # (6, n)
            else:
                st_in = torch.cat([fk[None, :n].expand(6, n, k, F), st.vst], -1)
                sdf_st = torch.sum(sdf(st_in) * st.wst, dim=-1)
            g = div_f32(torch.stack([sdf_st[0] - sdf_st[3], sdf_st[1] - sdf_st[4],
                                     sdf_st[2] - sdf_st[5]], -1), 2.0 * mcfg.num_grad_step)
            loss = loss + mcfg.weight_e * losses.eikonal_loss(g, valid=st.in_pool[:n])
            if certainty:
                cert_term = cert_term + torch.einsum("jnk,nk->", st.wst, rows[:n, :, F])
        if hs.sem is not None and st.sem_lab is not None:
            sem = _functional(hs.sem, hs.sem_params)
            if wf:
                sem_logp = torch.log_softmax(sem(geo_feat), dim=-1)
            else:
                sem_logp = torch.einsum("bk,bks->bs", w, torch.log_softmax(sem(per_in), dim=-1))
            loss = loss + mcfg.weight_s * losses.sem_nll_loss(
                sem_logp, st.sem_lab, valid=st.in_pool & (st.sem_lab > 0))
        leaves = [f] + ps
        if color is not None:
            cf = color.features.detach().requires_grad_(True)
            cps = [p.detach().requires_grad_(True) for p in color.params]
            chead = _functional(color.decoder, cps)
            crow = read(cf)
            if wf:
                cpred = dec.clip01(chead(torch.cat([torch.einsum("bk,bkc->bc", w, crow),
                                                    st.vin], -1)))
            else:
                cpred = torch.einsum("bk,bkc->bc", w,
                                     dec.clip01(chead(torch.cat([crow, st.vin], -1))))
            surf = st.in_pool & (torch.abs(st.labels) < mcfg.surface_sample_range)
            loss = loss + mcfg.weight_i * losses.color_diff_loss(
                cpred, st.col_lab, st.weights, mcfg.loss_weight_on, valid=surf)
            leaves = leaves + [cf] + cps
        grads = torch.autograd.grad(loss + cert_term, leaves)
    nh = len(ps)
    return (loss.detach(), grads[0], list(grads[1:1 + nh]),
            list(grads[1 + nh:]) if color is not None else None)


def mapping_loop_autograd(lm: npts.LocalMap, mc: npts.MapConfig, feats: torch.Tensor,
                          heads: Heads, opt: AdamState, pool: PoolState, mcfg: MapperConfig,
                          batch_idx: torch.Tensor, decoder_lr_scale: float,
                          after_pgo: bool = False, color: Optional[ColorState] = None,
                          mesh=None):
    """The per-frame training loop for the configurations the training
    kernels do not cover (``kernel_path_supported``): the same pool-cached
    batches, certainty channel and Adam as ``mapping_loop_cached``, with the
    loss and its gradients by torch autograd (``autograd_loss_and_grads``),
    the counterpart of the JAX package's ``mapping_loop_cached(use_kernel=
    False)``.  The pool rows come from the gather kernel once a call; each
    iteration gathers the feature rows with the gather kernel and scatters
    their gradient with the in-order scatter kernel, on plans built once a
    call.  The certainty column's gradient is harvested and kept out of
    Adam; the decoders' gradients are scaled by ``decoder_lr_scale``; one
    Adam step covers the features and every decoder leaf; feats[L] is
    zeroed after each step.  With a semantic head (``heads.sem`` and
    ``pool.sem_label``) the classes of the sampled rows are read once a
    call.  With ``color`` (and ``pool.color_label``) the colour labels of
    the sampled rows are read once a call (the gather kernel), the colour
    rows go through ``GatherRowsFn`` as the feature rows do (their gradient
    through the in-order scatter on the same plans), and the colour leaves
    take their own Adam step with the colour decoder's gradient scaled by
    ``decoder_lr_scale``: the JAX package's one Adam step over the whole
    tree, element by element the same; ``color`` is updated in place.  With
    ``mesh`` the loop runs data-parallel as ``mapping_loop_cached`` does
    (one all-reduce an iteration).
    Returns (lm with updated certainty / ts bookkeeping, feats, heads, opt,
    loss history (T,))."""
    if mesh is not None:
        from pin_slam_torch.parallel import mesh as pmesh
    T, B = batch_idx.shape
    L = mc.local_capacity
    F = feats.shape[1] - 1
    bt = _read_batches(lm, mc, pool, mcfg, batch_idx, after_pgo, mesh)
    sem_lab = (pool.sem_label[bt.flat_idx].reshape(T, B)
               if heads.sem is not None and pool.sem_label is not None else None)
    col_lab = (rowk.gather_rows(pool.color_label, bt.flat_idx).reshape(T, B, -1)
               if color is not None else None)
    plans = rowk.scatter_plans(bt.safe_g.reshape(T, -1), L + 1)
    cert_acc = torch.zeros((L + 1,), dtype=torch.float32, device=feats.device)
    hist = []
    for t in range(T):
        loss, gf, gh, gc = autograd_loss_and_grads(
            feats, heads, bt.step(t, mcfg.weighted_first, sem_lab, col_lab), mcfg,
            rowk.plan_at(plans, t), color=color)
        if mesh is not None:
            nh = len(gh)
            means, (gf,) = pmesh.reduce_grads(mesh, gh + (gc or []) + [loss], [gf])
            gh, gc, loss = means[:nh], (means[nh:-1] if gc is not None else None), means[-1]
            cert_acc = cert_acc + gf[:, F]
            gf = gf / mesh.size
        else:
            cert_acc = cert_acc + gf[:, F]
        gf[:, F] = 0.0
        new, opt = adam_step(mcfg, [feats] + heads.leaves(),
                             [gf] + [decoder_lr_scale * g for g in gh], opt)
        feats = new[0]
        feats[L] = 0.0
        heads = heads.with_leaves(new[1:])
        if color is not None:
            newc, color.opt = adam_step(mcfg, color.leaves(),
                                        [gc[0]] + [decoder_lr_scale * g for g in gc[1:]],
                                        color.opt)
            color.features, color.params = newc[0], newc[1:]
        hist.append(loss)
    return _fold_certainty(lm, cert_acc, bt.ts_proxy), feats, heads, opt, torch.stack(hist)


def _fold_exact(lm: npts.LocalMap, cert_acc: torch.Tensor,
                ts_acc: torch.Tensor) -> npts.LocalMap:
    """The local map with the uncached loop's certainty sums added and each
    touched point's update stamp raised to the newest frame that sampled it."""
    L = lm.attr_rows.shape[0] - 1
    attr = lm.attr_rows.clone()
    attr[:, npts.C_CERT] = attr[:, npts.C_CERT] + cert_acc
    attr[:, npts.C_TSU] = torch.maximum(attr[:, npts.C_TSU], ts_acc)
    attr[L] = npts.attr_sentinel_row(attr.device)
    return dataclasses.replace(lm, attr_rows=attr)


def mapping_loop(lm: npts.LocalMap, mc: npts.MapConfig, feats: torch.Tensor, heads: Heads,
                 opt: AdamState, pool: PoolState, mcfg: MapperConfig, offsets: torch.Tensor,
                 batch_idx: torch.Tensor, decoder_lr_scale: float, after_pgo: bool = False,
                 color: Optional[ColorState] = None):
    """The per-frame training loop with an exact kNN re-queried per batch,
    the JAX package's uncached ``mapping_loop`` (its ``_mapping_loop_fast``
    and ``_mapping_loop_general``, one function here: both compute the same
    loss), run under ``PIN_SLAM_EXACT_KNN=1``.

    ``feats`` is the (L+1, F) local feature table without a certainty
    column; ``heads`` the SDF (and semantic) decoder leaves; ``color`` the
    colour leaves (updated in place, as in ``mapping_loop_cached``).  Each
    iteration reads its batch's samples from the pool (one gather-kernel
    launch a call), runs ``npts.knn_search`` at them, and takes the loss of
    ``autograd_loss_and_grads`` on that neighbour set, features layer-normed
    with ``mc.layer_norm_on`` as ``npts.interpolate_features`` reads them;
    the eikonal stencil's 6 x (B / gradient_decimation) points reuse their
    base point's neighbours and features.  The decoders' gradients are
    scaled by ``decoder_lr_scale``, one Adam step covers the features and
    decoders (a second the colour leaves), and feats[L] is zeroed after it.  The IDW
    weights of every iteration (the stencil's summed) go into the certainty
    by one in-order scatter after the loop, and the newest sampling frame
    into each neighbour's update stamp by a scatter-max (order-free).
    Returns (lm with updated certainty / ts, feats, heads, opt, loss
    history (T,))."""
    dev = feats.device
    T, B = batch_idx.shape
    L = mc.local_capacity
    wf = mc.weighted_first
    n = B // mcfg.gradient_decimation if mcfg.ekional_loss_on else 0
    enc = mc.pos_encode

    flat_idx = batch_idx.reshape(-1)
    rows = rowk.gather_rows(pool.rows, flat_idx)
    coord = rows[:, P_COORD].reshape(T, B, 3)
    labels = rows[:, P_LABEL].reshape(T, B).contiguous()
    weights = torch.abs(rows[:, P_WEIGHT]).reshape(T, B)
    ts = rows[:, P_TS].reshape(T, B)
    in_pool = ((flat_idx < pool.fill) & (rows[:, P_TS] >= 0.0)).reshape(T, B)
    del rows
    sem_lab = (pool.sem_label[flat_idx].reshape(T, B)
               if heads.sem is not None and pool.sem_label is not None else None)
    col_lab = (rowk.gather_rows(pool.color_label, flat_idx).reshape(T, B, -1)
               if color is not None else None)

    # every batch's kNN (geometry: training moves no point), then one scatter
    # plan per iteration for the feature rows' gradient
    lidx = torch.stack([npts.knn_search(lm, mc, coord[t], offsets).lidx for t in range(T)])
    k = lidx.shape[2]
    valid = lidx < L
    plans = rowk.scatter_plans(lidx.reshape(T, B * k), L + 1)
    eps_mat = torch.eye(3, dtype=torch.float32, device=dev) * mcfg.num_grad_step

    cert_idx, cert_val, hist = [], [], []
    ts_acc = torch.zeros((L + 1,), dtype=torch.float32, device=dev)
    for t in range(T):
        idx_t, v_t = lidx[t], valid[t]
        nbr = lm.attr_rows[idx_t]                                         # (B, k, 16)
        quat = nbr[..., npts.C_QUAT] if after_pgo else None
        w, vblend, venc = idw_blend(coord[t], nbr[..., npts.C_POS], v_t, quat,
                                    return_per_neighbor=True, pos_encode=enc)
        st = _Step(gidx=idx_t, w=w, vin=vblend if wf else venc, labels=labels[t],
                   weights=weights[t], in_pool=in_pool[t],
                   sem_lab=None if sem_lab is None else sem_lab[t],
                   col_lab=None if col_lab is None else col_lab[t])
        cert_idx.append(idx_t.reshape(-1))
        cert_val.append(torch.where(v_t, w, torch.zeros_like(w)).reshape(-1))
        if n:
            sub = coord[t, :n]
            stencil = torch.cat([sub[None] + eps_mat[:, None, :], sub[None] - eps_mat[:, None, :]])
            st.wst, vb_st, venc_st = idw_blend(
                stencil, nbr[None, :n, :, npts.C_POS].expand(6, n, k, 3),
                v_t[None, :n].expand(6, n, k),
                quat[None, :n].expand(6, n, k, 4) if after_pgo else None,
                return_per_neighbor=True, pos_encode=enc)                 # (6, n, k), ...
            st.vst = vb_st if wf else venc_st
            cert_idx.append(idx_t[:n].reshape(-1))
            cert_val.append(torch.where(v_t[:n], torch.sum(st.wst, 0),
                                        torch.zeros_like(st.wst[0])).reshape(-1))
        tsb = torch.where(v_t, ts[t, :, None].expand(B, k), torch.zeros_like(w))
        ts_acc.scatter_reduce_(0, idx_t.reshape(-1), tsb.reshape(-1), "amax")

        loss, gf, gh, gc = autograd_loss_and_grads(
            feats, heads, st, mcfg, rowk.plan_at(plans, t), certainty=False,
            layer_norm=mc.layer_norm_on, color=color)
        new, opt = adam_step(mcfg, [feats] + heads.leaves(),
                             [gf] + [decoder_lr_scale * g for g in gh], opt)
        feats = new[0]
        feats[L] = 0.0
        heads = heads.with_leaves(new[1:])
        if color is not None:
            newc, color.opt = adam_step(mcfg, color.leaves(),
                                        [gc[0]] + [decoder_lr_scale * g for g in gc[1:]],
                                        color.opt)
            color.features, color.params = newc[0], newc[1:]
        hist.append(loss)
    cert = rowk.scatter_sum_rows(L + 1, torch.cat(cert_idx),
                                 torch.cat(cert_val)[:, None].contiguous(), skip_row=L)[:, 0]
    return _fold_exact(lm, cert, ts_acc), feats, heads, opt, torch.stack(hist)


def compute_new_sample_mask(lm: npts.LocalMap, mc: npts.MapConfig, mcfg: MapperConfig,
                            coord_world: torch.Tensor, sdf_label: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """Current-frame samples in newly observed regions: low certainty AND
    close to the surface."""
    cert = npts.query_certainty(lm, mc, coord_world)
    return (valid & (cert < mcfg.new_certainty_thre)
            & (torch.abs(sdf_label) < mcfg.surface_sample_range * 3.0))


# ----------------------------------------------------------------------
# bundle adjustment
# ----------------------------------------------------------------------


def query_sdf(lm: npts.LocalMap, mc: npts.MapConfig, mcfg: MapperConfig, offsets,
              pts: torch.Tensor, feats: torch.Tensor, decoder, after_pgo: bool = True):
    """kNN + IDW interpolation + decode at ``pts`` with the (L+1, F) feature
    table ``feats``, differentiable in ``pts`` and ``feats``.  The kNN is
    pure indexing (no gradient); the feature rows come through
    ``rows.GatherRowsFn`` (the gather kernel, and the in-order scatter for
    their gradient; the sentinel row L gets none).  Returns (sdf (B,),
    knn lidx (B,k), IDW weights (B,k))."""
    L = mc.local_capacity
    with torch.no_grad():
        knn = npts.knn_search(lm, mc, pts.detach(), offsets)
    lmf = dataclasses.replace(lm, geo_features=feats)
    geo_feat, w, _ = npts.interpolate_features(
        lmf, mc, pts, knn.lidx, after_pgo=after_pgo,
        gather=lambda tab, idx: rowk.GatherRowsFn.apply(tab, idx, L))
    sdf, _ = decoder.blended_sdf(geo_feat, w, mc.weighted_first, mcfg.sdf_scale)
    return sdf, knn.lidx, w


def ba_value_and_grad(lm: npts.LocalMap, mc: npts.MapConfig, mcfg: MapperConfig, offsets,
                      decoder, feats: torch.Tensor, xi: torch.Tensor,
                      poses_full: torch.Tensor, window_start: int, local: torch.Tensor,
                      ts: torch.Tensor, valid: torch.Tensor):
    """Bundle adjustment's loss at one batch and its gradients in the
    features and the window's corrections.  Each sample's world point is
    dT(ts) @ poses_full[ts] @ local, where dT is exp(xi[ts - window_start])
    inside the window and the identity before it; the loss is the mean of
    sdf^2 over the ``valid`` samples.  The per-sample pose selection is a
    one-hot (B, window) product, so its gradient is a matrix product too
    (no float atomics, as an indexed gather's backward would add); the
    feature rows' gradient comes from the in-order row scatter
    (``query_sdf``).  Returns (loss, d loss / d feats, d loss / d xi)."""
    window = xi.shape[0]
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        x = xi.detach().requires_grad_(True)
        T_base = poses_full[ts]
        in_win = ts >= window_start
        widx = torch.clamp(ts - window_start, 0, window - 1)
        onehot = (widx[:, None] == torch.arange(window, device=ts.device)[None, :]
                  ).to(x.dtype)
        dT = (onehot @ se3_expmap(x).reshape(window, 16)).reshape(-1, 4, 4)
        eye = torch.eye(4, dtype=x.dtype, device=x.device).expand_as(dT)
        dT = torch.where(in_win[:, None, None], dT, eye)
        T = dT @ T_base
        coord = torch.einsum("nij,nj->ni", T[:, :3, :3], local) + T[:, :3, 3]
        sdf, _, _ = query_sdf(lm, mc, mcfg, offsets, coord, f, decoder)
        per = torch.where(valid, sdf ** 2, torch.zeros_like(sdf))
        loss = torch.sum(per) / torch.clamp(torch.sum(valid), min=1)
        g_f, g_x = torch.autograd.grad(loss, (f, x))
    return loss.detach(), g_f, g_x


class OptaxAdam:
    """Adam(0.9, 0.99, eps) on one tensor, in ``optax.adam``'s order of
    operations (the JAX package's bundle adjustment uses optax): returns the
    update -lr * m_hat / (sqrt(v_hat) + eps) that is added to the parameter."""

    def __init__(self, like: torch.Tensor, lr: float, eps: float):
        self.lr, self.eps, self.count = lr, eps, 0
        self.m, self.v = torch.zeros_like(like), torch.zeros_like(like)

    def update(self, g: torch.Tensor) -> torch.Tensor:
        b1, b2 = 0.9, 0.99
        self.count += 1
        self.m = (1.0 - b1) * g + b1 * self.m
        self.v = (1.0 - b2) * g ** 2 + b2 * self.v
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        return -self.lr * ((self.m / bc1) / (torch.sqrt(self.v / bc2) + self.eps))


def bundle_adjustment_loop(lm: npts.LocalMap, mc: npts.MapConfig, feats: torch.Tensor,
                           decoder, pool: PoolState, mcfg: MapperConfig, offsets,
                           poses_full: torch.Tensor, window_start: int, xi: torch.Tensor,
                           batch_idx: torch.Tensor, lr_pose_ratio: float = 0.1):
    """Sliding-window bundle adjustment: ``batch_idx.shape[0]`` Adam
    iterations over the local features (L+1, F) and the se(3) corrections
    ``xi`` (window, 6) of the poses from ``window_start`` on, left-composed
    onto ``poses_full`` (T, 4, 4).  Each iteration's samples are the pool
    rows ``batch_idx[t]`` that are filled surface samples (|label| < 1e-6)
    with a frame id; the loss is ``ba_value_and_grad``'s.  The decoder stays
    frozen, the sentinel feature row L is zeroed after every step, and the
    poses move by ``lr_pose_ratio`` times Adam's update.  The colour features
    are not touched: their gradient is zero here, and Adam (the JAX
    package's optax) moves a leaf with a zero gradient and zero moments by
    exactly 0.  Returns (feats,
    xi, loss history (T,))."""
    L = mc.local_capacity
    feats = feats.contiguous()
    surface = torch.abs(pool.rows[:, P_LABEL]) < 1e-6
    opt_f = OptaxAdam(feats, mcfg.lr, mcfg.adam_eps)
    opt_x = OptaxAdam(xi, mcfg.lr, mcfg.adam_eps)
    hist = []
    for t in range(batch_idx.shape[0]):
        idx = batch_idx[t]
        rows_b = pool.rows[idx]
        ts = rows_b[:, P_TS].to(torch.int64)
        valid = (idx < pool.fill) & surface[idx] & (rows_b[:, P_TS] >= 0.0)
        loss, g_f, g_x = ba_value_and_grad(lm, mc, mcfg, offsets, decoder, feats, xi,
                                           poses_full, window_start, rows_b[:, P_LOCAL],
                                           ts, valid)
        feats = feats + opt_f.update(g_f)
        feats[L] = 0.0
        xi = xi + lr_pose_ratio * opt_x.update(g_x)
        hist.append(loss)
    return feats, xi, torch.stack(hist)
