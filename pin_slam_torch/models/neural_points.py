"""Neural point map, torch counterpart of ``pin_slam_tpu/models/neural_points.py``
(main-path, loop-closure and end-of-run subset): a fixed-capacity
structure-of-arrays point buffer whose last row is a sentinel, a global
voxel hash, the per-frame local map with its packed local hash, kNN probes,
IDW feature interpolation, the elastic deformation and rehash after a
pose-graph optimisation, and at the end of a run the map's finalisation and
the read-only whole-map views the mesher queries.  With ``color_on`` every
table of geometric features has a colour feature table beside it, whose
rows move with the geometric ones (insert, local map, write-back,
finalisation) and which ``interpolate_features(query_color=True)`` blends.

The row layouts are the JAX package's, so the two can be compared row for
row.  Where the JAX package returns new arrays (XLA donation), the port
updates the large global tables IN PLACE (``map_insert``,
``assign_local_to_global``); callers that need the old state keep a clone.
Integer payloads (local/global indices) still ride value-cast float32 rows,
exact below 2^24, hence the ``map_capacity <= 2^24`` check.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pin_slam_torch.ops.hash3d import grid_coords, spatial_hash
from pin_slam_torch.ops.scatter import nonzero_static, scatter_set_last
from pin_slam_torch.ops.transforms import apply_quaternion_rotation, quat_multiply, rotmat_to_quat
from pin_slam_torch.ops.voxel import (sqnorm3, voxel_down_sample_mask,
                                      voxel_down_sample_min_value_mask)

_SENTINEL_POS = 1e8
_INVALID_DIST2 = 9e3


@dataclasses.dataclass(frozen=True)
class MapConfig:
    capacity: int
    local_capacity: int
    hash_size: int
    voxel_size: float
    feature_dim: int
    nn_k: int
    max_valid_dist2: float
    local_map_radius: float
    travel_dist_window: float
    idw_eps: float = 1e-15
    use_mid_ts: bool = False
    weighted_first: bool = True
    local_hash_size: int = 1 << 22
    brick: tuple = (1, 1, 1)
    color_on: bool = False            # colour feature tables beside the geometric ones

    @property
    def nsub(self) -> int:
        bx, by, bz = self.brick
        return bx * by * bz

    @property
    def brick_rows(self) -> int:
        return self.local_hash_size // self.nsub

    @property
    def assign_span(self) -> int:
        return min(self.capacity, 2 * self.local_capacity)

    @staticmethod
    def from_config(cfg) -> "MapConfig":
        if int(cfg.map_capacity) > (1 << 24):
            raise ValueError("map_capacity must be <= 2^24 (f32 value-cast indices)")
        wb = getattr(cfg, "use_brick_hash", False)
        if isinstance(wb, (tuple, list)):
            brick = tuple(int(b) for b in wb)
        elif wb is True or wb in ("true", "auto"):
            brick = (2, 2, 1)
        else:
            brick = (1, 1, 1)
        nsub = brick[0] * brick[1] * brick[2]
        return MapConfig(
            brick=brick,
            capacity=cfg.map_capacity,
            local_capacity=cfg.local_map_capacity,
            hash_size=cfg.buffer_size,
            voxel_size=cfg.voxel_size_m,
            feature_dim=cfg.feature_dim,
            nn_k=cfg.query_nn_k,
            max_valid_dist2=cfg.max_valid_dist2,
            local_map_radius=cfg.local_map_radius,
            travel_dist_window=cfg.diff_travel_dist_local,
            use_mid_ts=cfg.use_mid_ts,
            weighted_first=cfg.weighted_first,
            color_on=cfg.color_on,
            # same local-hash sizing rule as the JAX package (identical rows)
            local_hash_size=min(
                1 << 21 if nsub > 1 else 1 << 20,
                max(1 << 19, 1 << ((int(cfg.local_map_capacity) - 1).bit_length() + 3))),
        )


def neighbor_offsets(num_nei_cells: int, search_alpha: float) -> np.ndarray:
    """Sphere-clipped integer offset template (K=33 for (2, 0.2), 81 for (2, 0.5))."""
    r = np.arange(-num_nei_cells, num_nei_cells + 1)
    dx = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    keep = (dx ** 2).sum(-1) < (num_nei_cells + search_alpha) ** 2
    return dx[keep].astype(np.int32)


class ProbeTemplate(NamedTuple):
    cells: torch.Tensor    # (K, 3) int32
    bricks: torch.Tensor   # (P, Kb, 3) int32 parity-indexed brick offsets
    memb: torch.Tensor     # (P, Kb*nsub) f32 template membership per sub-cell


def make_probe_template(mc: MapConfig, num_nei_cells: int, search_alpha: float,
                        device=None) -> ProbeTemplate:
    """Host construction of the parity-indexed brick probe template (identical
    integer tables to the JAX package's)."""
    cells = neighbor_offsets(num_nei_cells, search_alpha)
    bx, by, bz = mc.brick
    bvec = np.asarray([bx, by, bz], np.int64)
    nsub = mc.nsub
    cell_set = {tuple(c) for c in cells.tolist()}
    subs = np.stack(np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    parities = [np.asarray([px, py, pz], np.int64)
                for px in range(bx) for py in range(by) for pz in range(bz)]
    bricks_per_p, memb_per_p = [], []
    kb = 0
    for p in parities:
        b = np.unique(np.floor_divide(cells + p, bvec), axis=0).astype(np.int32)
        bricks_per_p.append(b)
        kb = max(kb, len(b))
    far = np.int32(1 << 20)
    for j, (p, b) in enumerate(zip(parities, bricks_per_p)):
        m = np.zeros((kb, nsub), np.float32)
        for i in range(len(b)):
            for s in range(nsub):
                dx = b[i] * bvec + subs[s] - p
                m[i, s] = float(tuple(int(v) for v in dx) in cell_set)
        bricks_per_p[j] = np.concatenate([b, np.full((kb - len(b), 3), far, np.int32)])
        memb_per_p.append(m.T.reshape(-1))
    return ProbeTemplate(
        cells=torch.as_tensor(cells, device=device),
        bricks=torch.as_tensor(np.stack(bricks_per_p), device=device),
        memb=torch.as_tensor(np.stack(memb_per_p), device=device))


ATTR_DIM = 16
HASH_ROW_DIM = 8
BRICK_SUB_DIM = 5
C_POS = slice(0, 3)
C_QUAT = slice(3, 7)
C_CERT = 7
C_TSC = 8
C_TSU = 9
C_TRC = 10
C_TRU = 11


def attr_sentinel_row(device=None) -> torch.Tensor:
    row = torch.zeros((ATTR_DIM,), dtype=torch.float32, device=device)
    row[:3] = _SENTINEL_POS
    row[3] = 1.0
    return row


@dataclasses.dataclass
class MapState:
    """Global neural point map (capacity+1 rows, last row = sentinel)."""
    attr_rows: torch.Tensor      # (cap+1, 16) f32
    geo_features: torch.Tensor   # (cap+1, F) f32
    count: torch.Tensor          # () int64
    hash_table: torch.Tensor     # (H+1,) int64; value cap = empty; slot H = dump
    color_features: Optional[torch.Tensor] = None   # (cap+1, F) f32 with color_on

    @property
    def positions(self) -> torch.Tensor:
        return self.attr_rows[:, C_POS]


@dataclasses.dataclass
class LocalMap:
    """Fixed-size trainable window of the map (local_capacity+1 rows)."""
    indices: torch.Tensor        # (L+1,) int64 local -> global, pad = cap
    attr_rows: torch.Tensor      # (L+1, 16) f32
    geo_features: torch.Tensor   # (L+1, F) f32
    count: torch.Tensor          # () int64
    member_mask: torch.Tensor    # (cap+1,) bool
    lo1: torch.Tensor            # () int64 anchor of span 1
    lo2: torch.Tensor            # () int64 anchor of span 2
    origin: torch.Tensor         # (3,) f32
    hash_rows: torch.Tensor      # packed local hash rows (see _pack_hash_rows)
    color_features: Optional[torch.Tensor] = None   # (L+1, F) f32 with color_on

    @property
    def positions(self) -> torch.Tensor:
        return self.attr_rows[:, C_POS]


def init_map_state(mc: MapConfig, device=None) -> MapState:
    cap, F = mc.capacity, mc.feature_dim
    return MapState(
        attr_rows=attr_sentinel_row(device).expand(cap + 1, ATTR_DIM).clone(),
        geo_features=torch.zeros((cap + 1, F), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        hash_table=torch.full((mc.hash_size + 1,), cap, dtype=torch.int64, device=device),
        color_features=(torch.zeros((cap + 1, F), dtype=torch.float32, device=device)
                        if mc.color_on else None))


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def subcell_hash(mc: MapConfig, cells: torch.Tensor) -> torch.Tensor:
    """Row index of a CELL coordinate [...,3] in the local hash table."""
    if mc.nsub == 1:
        return spatial_hash(cells, mc.local_hash_size)
    bx, by, bz = mc.brick
    bvec = torch.tensor([bx, by, bz], dtype=cells.dtype, device=cells.device)
    bco = _floor_div(cells, bvec)
    sub = (cells - bco * bvec).to(torch.int64)
    s = sub[..., 0] * (by * bz) + sub[..., 1] * bz + sub[..., 2]
    return spatial_hash(bco, mc.brick_rows) * mc.nsub + s


def _pack_hash_rows(mc: MapConfig, positions: torch.Tensor, count: torch.Tensor,
                    indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed per-frame local hash: slot -> [x, y, z, lidx, gidx(, pad x3)].
    Colliding points: the highest local index wins, as the JAX package's
    in-order scatter does on the CPU."""
    dev = positions.device
    L = mc.local_capacity
    lidx = torch.arange(L + 1, dtype=torch.int64, device=dev)
    active = lidx < count
    cells = grid_coords(positions, mc.voxel_size)
    gidx = (indices if indices is not None
            else torch.full((L + 1,), mc.capacity, dtype=torch.int64, device=dev))
    cols = [positions, lidx.to(torch.float32)[:, None], gidx.to(torch.float32)[:, None]]
    if mc.nsub == 1:
        Hl = mc.local_hash_size
        slot = torch.where(active, subcell_hash(mc, cells), torch.full_like(lidx, Hl))
        rows = torch.cat(cols + [torch.zeros((L + 1, 3), dtype=torch.float32, device=dev)], 1)
        sentinel = torch.tensor([_SENTINEL_POS] * 3 + [L, mc.capacity, 0.0, 0.0, 0.0],
                                dtype=torch.float32, device=dev)
        table = sentinel.expand(Hl + 1, HASH_ROW_DIM)
        return scatter_set_last(table, slot, rows)
    nsub, Hb = mc.nsub, mc.brick_rows
    slot = torch.where(active, subcell_hash(mc, cells), torch.full_like(lidx, Hb * nsub))
    rows = torch.cat(cols, 1)
    sentinel = torch.tensor([_SENTINEL_POS] * 3 + [L, mc.capacity],
                            dtype=torch.float32, device=dev)
    table = sentinel.expand((Hb + 1) * nsub, BRICK_SUB_DIM)
    return scatter_set_last(table, slot, rows)


def init_local_map(mc: MapConfig, device=None) -> LocalMap:
    L, F = mc.local_capacity, mc.feature_dim
    attr_rows = attr_sentinel_row(device).expand(L + 1, ATTR_DIM).clone()
    count = torch.zeros((), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return LocalMap(
        indices=torch.full((L + 1,), mc.capacity, dtype=torch.int64, device=device),
        attr_rows=attr_rows,
        geo_features=torch.zeros((L + 1, F), dtype=torch.float32, device=device),
        count=count,
        member_mask=torch.zeros((mc.capacity + 1,), dtype=torch.bool, device=device),
        lo1=zero.clone(), lo2=zero.clone(),
        origin=torch.zeros((3,), dtype=torch.float32, device=device),
        hash_rows=_pack_hash_rows(mc, attr_rows[:, C_POS], count),
        color_features=(torch.zeros((L + 1, F), dtype=torch.float32, device=device)
                        if mc.color_on else None))


# ----------------------------------------------------------------------
# map update (insert)
# ----------------------------------------------------------------------


def map_insert(state: MapState, mc: MapConfig, points: torch.Tensor,
               valid: torch.Tensor, cur_ts: int, travel_dist: torch.Tensor,
               downsample_table_size: int = 1 << 20,
               insert_bucket: Optional[int] = None) -> MapState:
    """Insert new observations (voxel-downsample -> hash -> keep empty /
    collided / stale voxels -> one contiguous append at ``count``).
    Updates ``state``'s tables in place and returns it."""
    dev = points.device
    cap = mc.capacity
    m = points.shape[0]
    bucket = min(m, cap) if insert_bucket is None else min(insert_bucket, m, cap)

    keep = voxel_down_sample_mask(points, valid, mc.voxel_size, downsample_table_size)
    grid = grid_coords(points, mc.voxel_size)
    h = spatial_hash(grid, mc.hash_size)
    existing = state.hash_table[h]
    old = state.attr_rows[existing]
    dist2 = sqnorm3(old[:, C_POS] - points)
    travel_now = travel_dist[cur_ts]
    delta_travel = travel_now - old[:, C_TRU]
    is_empty = existing == cap
    update_mask = keep & (is_empty | (dist2 > 3.0 * mc.voxel_size ** 2)
                          | (delta_travel > mc.travel_dist_window))

    ins_idx = nonzero_static(update_mask, bucket, 0)
    n_ins = torch.sum(update_mask)
    ok = state.count <= cap - bucket
    ar = torch.arange(bucket, dtype=torch.int64, device=dev)
    placed = (ar < n_ins) & ok

    pts_c = points[ins_idx].to(torch.float32)
    h_c = h[ins_idx]
    rows = torch.zeros((bucket, ATTR_DIM), dtype=torch.float32, device=dev)
    rows[:, C_POS] = pts_c
    rows[:, 3] = 1.0
    ts_f = float(cur_ts)
    rows[:, C_TSC] = ts_f
    rows[:, C_TSU] = ts_f
    rows[:, C_TRC] = travel_now
    rows[:, C_TRU] = travel_now

    start = torch.clamp(state.count, max=cap - bucket)
    dst = start + ar
    cur_attr = state.attr_rows[dst]
    state.attr_rows.index_copy_(0, dst, torch.where(placed[:, None], rows, cur_attr))
    for table in (state.geo_features, state.color_features):
        if table is not None:
            cur = table[dst]
            table.index_copy_(0, dst, torch.where(placed[:, None], torch.zeros_like(cur), cur))

    slot = torch.where(placed, h_c, torch.full_like(h_c, mc.hash_size))
    vals = torch.where(placed, dst, torch.full_like(dst, cap))
    state.hash_table = scatter_set_last(state.hash_table, slot, vals)
    state.count = state.count + torch.sum(placed)
    return state


# ----------------------------------------------------------------------
# local map
# ----------------------------------------------------------------------


def build_local_map(state: MapState, mc: MapConfig, origin: torch.Tensor,
                    cur_ts: int, travel_dist: torch.Tensor,
                    travel_window: Optional[float] = None) -> LocalMap:
    """Points within radius AND the travel-distance window, constrained to
    two contiguous index spans (so the write-back is two dense merges).
    ``travel_window`` overrides ``mc.travel_dist_window`` (loop verification
    rebuilds the map roughly as it was at the loop frame)."""
    dev = state.attr_rows.device
    cap, L = mc.capacity, mc.local_capacity
    dist2 = sqnorm3(state.attr_rows[:cap, C_POS] - origin)
    travel_now = travel_dist[cur_ts]
    if mc.use_mid_ts:
        ts_used = ((state.attr_rows[:cap, C_TSC] + state.attr_rows[:cap, C_TSU]) / 2
                   ).to(torch.int64)
        travel_used = travel_dist[ts_used]
    else:
        travel_used = state.attr_rows[:cap, C_TRC]
    delta_travel = torch.abs(travel_now - travel_used)
    window = mc.travel_dist_window if travel_window is None else float(travel_window)
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    active = rows < state.count
    mask = active & (dist2 < mc.local_map_radius ** 2) & (delta_travel < window)

    S = mc.assign_span
    ar = torch.arange(S, dtype=torch.int64, device=dev)
    lo1 = torch.argmax(mask.to(torch.int32))          # first member (0 if none)
    lo2 = torch.clamp(state.count - S, min=0)
    mask_pad = torch.cat([mask, torch.zeros((S,), dtype=torch.bool, device=dev)])
    m1 = mask_pad[lo1 + ar] & (lo1 + ar < lo2)
    m2 = mask_pad[lo2 + ar]
    mm = torch.cat([m1, m2])
    rank = torch.cumsum(mm.to(torch.int64), 0) - 1
    mm = mm & (rank < L)

    j = nonzero_static(mm, L, 2 * S)
    idx = torch.where(j < S, lo1 + j,
                      torch.where(j < 2 * S, lo2 + (j - S), torch.full_like(j, cap)))
    count = torch.sum(mm)

    mask_full = torch.zeros((cap + S,), dtype=torch.bool, device=dev)
    mask_full[lo1 + ar] = mm[:S]
    mask_full[lo2 + ar] = mm[S:]
    member_mask = torch.cat([mask_full[:cap], torch.zeros((1,), dtype=torch.bool, device=dev)])

    idx_pad = torch.cat([idx, torch.full((1,), cap, dtype=torch.int64, device=dev)])
    attr_rows = state.attr_rows[idx_pad]
    attr_rows[L] = attr_sentinel_row(dev)
    geo_features = state.geo_features[idx_pad]
    return LocalMap(indices=idx_pad, attr_rows=attr_rows, geo_features=geo_features,
                    count=count, member_mask=member_mask, lo1=lo1.to(torch.int64),
                    lo2=lo2, origin=origin.to(torch.float32).clone(),
                    hash_rows=_pack_hash_rows(mc, attr_rows[:, C_POS], count, idx_pad),
                    color_features=_rows_or_none(state.color_features, idx_pad))


def build_query_view(state: MapState, mc: MapConfig, origin: torch.Tensor,
                     radius: float) -> LocalMap:
    """Read-only local map over every point within ``radius`` of ``origin``:
    no travel window and no contiguous spans (members may lie anywhere in
    the index range); on overflow the oldest ``local_capacity`` are kept.
    For whole-map queries (chunked meshing), never for training:
    ``assign_local_to_global`` needs the spans ``build_local_map`` makes."""
    dev = state.attr_rows.device
    cap, L = mc.capacity, mc.local_capacity
    dist2 = sqnorm3(state.attr_rows[:cap, C_POS] - origin)
    rows = torch.arange(cap, dtype=torch.int64, device=dev)
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    mask = (rows < state.count) & (dist2 < r * r)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    mask = mask & (rank < L)

    idx_pad = torch.cat([nonzero_static(mask, L, cap),
                         torch.full((1,), cap, dtype=torch.int64, device=dev)])
    count = torch.sum(mask)
    attr_rows = state.attr_rows[idx_pad]
    attr_rows[L] = attr_sentinel_row(dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return LocalMap(indices=idx_pad, attr_rows=attr_rows,
                    geo_features=state.geo_features[idx_pad], count=count,
                    member_mask=torch.cat([mask, torch.zeros((1,), dtype=torch.bool,
                                                             device=dev)]),
                    lo1=zero, lo2=zero.clone(),
                    origin=origin.to(torch.float32).clone(),
                    hash_rows=_pack_hash_rows(mc, attr_rows[:, C_POS], count, idx_pad),
                    color_features=_rows_or_none(state.color_features, idx_pad))


def _rows_or_none(table: Optional[torch.Tensor], idx: torch.Tensor) -> Optional[torch.Tensor]:
    return table[idx] if table is not None else None


def assign_local_to_global(state: MapState, lm: LocalMap, mc: MapConfig,
                           travel_dist: Optional[torch.Tensor] = None) -> MapState:
    """Write trained local features + certainty/ts bookkeeping back into the
    global map through the two span merges (in place; returns ``state``)."""
    dev = state.attr_rows.device
    cap, L, S = mc.capacity, mc.local_capacity, mc.assign_span
    wb = lm.attr_rows.clone()
    if travel_dist is not None:
        wb[:, C_TRU] = travel_dist[wb[:, C_TSU].to(torch.int64)]
    wb[L] = attr_sentinel_row(dev)
    geo_wb = lm.geo_features.clone()
    geo_wb[L] = 0.0
    tables = [(state.attr_rows, wb), (state.geo_features, geo_wb)]
    if state.color_features is not None and lm.color_features is not None:
        col_wb = lm.color_features.clone()
        col_wb[L] = 0.0
        tables.append((state.color_features, col_wb))
    rank = torch.cumsum(lm.member_mask.to(torch.int64), 0) - 1
    ar = torch.arange(S, dtype=torch.int64, device=dev)

    def merge(lo, enabled):
        lo = torch.clamp(lo, max=cap + 1 - S)       # XLA dynamic_slice clamping
        sl = lo + ar
        m_s = lm.member_mask[sl] & enabled
        src = torch.where(m_s, torch.clamp(rank[sl], max=L), torch.full_like(sl, L))
        for table, rows in tables:
            cur = table[sl]
            table.index_copy_(0, sl, torch.where(m_s[:, None], rows[src], cur))

    # span 1 only when it lies before the tail span (a no-op merge otherwise)
    merge(lm.lo1, lm.lo1 < lm.lo2)
    merge(lm.lo2, torch.ones((), dtype=torch.bool, device=dev))
    return state


def exact_k_min(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest values along the last axis, ascending, lowest
    index first among ties (k argmin passes, chosen columns masked to inf)."""
    d = d2.clone()
    sel = []
    for _ in range(k):
        j = torch.argmin(d, dim=-1)
        sel.append(j)
        d.scatter_(-1, j[..., None], float("inf"))
    return torch.stack(sel, dim=-1)


# ----------------------------------------------------------------------
# query: hash-probe -> kNN -> IDW interpolation
# ----------------------------------------------------------------------


class KnnResult(NamedTuple):
    lidx: torch.Tensor       # (B, k) local indices, sentinel = L
    nn_count: torch.Tensor   # (B,) valid neighbors before top-k


def brick_gather_fm(lm: LocalMap, mc: MapConfig, tmpl: ProbeTemplate,
                    probe_pts: torch.Tensor) -> torch.Tensor:
    """Brick-layout probe gather -> field-major rows (G, 5*Kc), columns
    [x*Kc | y*Kc | z*Kc | lidx*Kc | gidx*Kc], candidate order c = s*Kb + kb;
    sub-cells outside the sphere template get the sentinel local index."""
    return gather_brick_rows_fm(lm.hash_rows, tmpl.bricks, tmpl.memb, probe_pts,
                                mc.voxel_size, mc.brick, mc.brick_rows, mc.local_capacity)


def gather_brick_rows_fm(hash_rows: torch.Tensor, bricks: torch.Tensor, memb: torch.Tensor,
                         probe_pts: torch.Tensor, voxel_size: float, brick, Hb: int,
                         L: int) -> torch.Tensor:
    """``brick_gather_fm`` on its arrays: the packed table ((Hb+1)*nsub, 5),
    the template's parity tables ``bricks`` (nsub, Kb, 3) and ``memb``
    (nsub, Kb*nsub), the local capacity L."""
    bx, by, bz = brick
    nsub = bx * by * bz
    g = grid_coords(probe_pts, voxel_size)
    bvec = torch.tensor([bx, by, bz], dtype=g.dtype, device=g.device)
    bco = _floor_div(g, bvec)
    p = (g - bco * bvec).to(torch.int64)
    bidx = p[:, 0] * (by * bz) + p[:, 1] * bz + p[:, 2]
    boffs = bricks[bidx]                                     # (G,Kb,3)
    hb = spatial_hash(bco[:, None, :] + boffs, Hb)           # (G,Kb)
    G, Kb = hb.shape
    raw = hash_rows.view(Hb + 1, nsub * BRICK_SUB_DIM)[hb]
    fields = raw.view(G, Kb, nsub, BRICK_SUB_DIM).permute(3, 0, 2, 1).reshape(
        BRICK_SUB_DIM, G, nsub * Kb).clone()
    fields[3] = torch.where(memb[bidx] > 0.5, fields[3], torch.full_like(fields[3], float(L)))
    return fields.permute(1, 0, 2).reshape(G, BRICK_SUB_DIM * nsub * Kb)


def knn_search(lm: LocalMap, mc: MapConfig, points: torch.Tensor,
               offsets: torch.Tensor) -> KnnResult:
    """Voxel-hash neighborhood probe + exact top-k by distance."""
    L = mc.local_capacity
    grid = grid_coords(points, mc.voxel_size)
    cells = grid[:, None, :] + offsets[None, :, :].to(grid.dtype)
    rows = lm.hash_rows[subcell_hash(mc, cells)]
    lidx = rows[..., 3].to(torch.int64)
    dist2 = sqnorm3(rows[..., :3] - points[:, None, :])
    valid = (lidx < L) & (dist2 <= mc.max_valid_dist2)
    lidx = torch.where(valid, lidx, torch.full_like(lidx, L))
    nn_count = torch.sum(valid, dim=-1)
    dist2 = torch.where(valid, dist2, torch.full_like(dist2, _INVALID_DIST2))
    k = min(mc.nn_k, offsets.shape[0])
    sel = exact_k_min(dist2, k)
    return KnnResult(lidx=torch.gather(lidx, 1, sel), nn_count=nn_count)


def idw_weights(dist2: torch.Tensor, valid: torch.Tensor, eps: float):
    """Normalized inverse-distance weights; (w_hat, S, w)."""
    w_hat = 1.0 / (dist2 + eps)
    w_hat = torch.where(valid, w_hat, torch.zeros_like(w_hat))
    nn_any = torch.any(valid, dim=-1, keepdim=True)
    w_hat = torch.where(nn_any, w_hat, torch.full_like(w_hat, eps))
    S = torch.sum(w_hat, dim=-1, keepdim=True)
    w = w_hat / S
    return w_hat, S, torch.where(valid, w, torch.zeros_like(w))


def interpolate_features(lm: LocalMap, mc: MapConfig, points: torch.Tensor,
                         knn_lidx: torch.Tensor, after_pgo: bool = False,
                         gather=None, query_color: bool = False):
    """IDW interpolation at the selected neighbors (differentiable in
    ``points`` and ``lm.geo_features``).  After a pose-graph optimisation
    (``after_pgo``) each offset vector is rotated into its neighbour's frame
    by the neighbour's quaternion.  ``gather(table, idx)`` reads the feature
    rows (default ``table[idx]``; bundle adjustment passes the row kernels'
    autograd function, whose gradient is deterministic).  Returns (geo_feat
    [B,F+3] or per-neighbor [B,k,F+3], weights [B,k], certainty [B]); with
    ``query_color`` (geo_feat, color_feat of the same layout from
    ``lm.color_features``, weights, certainty), as the JAX function
    returns."""
    L = mc.local_capacity
    valid = knn_lidx < L
    safe_idx = torch.where(valid, knn_lidx, torch.full_like(knn_lidx, L))
    pose = lm.attr_rows[safe_idx]
    vec = points[:, None, :] - pose[..., C_POS]
    dist2 = torch.where(valid, sqnorm3(vec), torch.full_like(vec[..., 0], _INVALID_DIST2))
    if after_pgo:
        vec = apply_quaternion_rotation(pose[..., C_QUAT], vec)
    vec = torch.where(valid[..., None], vec, torch.zeros_like(vec))
    feats = lm.geo_features[safe_idx] if gather is None else gather(lm.geo_features, safe_idx)
    feats = torch.where(valid[..., None], feats, torch.zeros_like(feats))
    _, _, w = idw_weights(dist2, valid, mc.idw_eps)
    geo_vec = torch.cat([feats, vec], dim=-1)
    geo_out = torch.sum(geo_vec * w[..., None], dim=1) if mc.weighted_first else geo_vec
    cert = torch.where(valid, pose[..., C_CERT], torch.zeros_like(w))
    cert_q = torch.sum(cert * w, dim=-1)
    if not query_color:
        return geo_out, w, cert_q
    cfeats = lm.color_features[safe_idx]
    cfeats = torch.where(valid[..., None], cfeats, torch.zeros_like(cfeats))
    color_vec = torch.cat([cfeats, vec], dim=-1)
    color_out = torch.sum(color_vec * w[..., None], dim=1) if mc.weighted_first else color_vec
    return geo_out, color_out, w, cert_q


def query_certainty(lm: LocalMap, mc: MapConfig, points: torch.Tensor) -> torch.Tensor:
    """Neighbor certainty in the query's own voxel (0 if none)."""
    L = mc.local_capacity
    rows = lm.hash_rows[subcell_hash(mc, grid_coords(points, mc.voxel_size))]
    lidx = rows[:, 3].to(torch.int64)
    valid = (lidx < L) & (sqnorm3(rows[:, :3] - points) <= mc.max_valid_dist2)
    cert = lm.attr_rows[torch.where(valid, lidx, torch.full_like(lidx, L)), C_CERT]
    return torch.where(valid, cert, torch.zeros_like(cert))


# ----------------------------------------------------------------------
# map maintenance after a pose-graph optimisation
# ----------------------------------------------------------------------


def _ts_used(state: MapState, mc: MapConfig) -> torch.Tensor:
    tsc = state.attr_rows[:, C_TSC].to(torch.int64)
    if mc.use_mid_ts:
        return torch.div(tsc + state.attr_rows[:, C_TSU].to(torch.int64), 2,
                         rounding_mode="floor")
    return tsc


def adjust_map(state: MapState, mc: MapConfig, pose_diff: torch.Tensor) -> MapState:
    """Elastic map deformation: move every neural point by the pose
    correction of its (mid-)timestamp and compose its quaternion.
    pose_diff (T,4,4) float32 per-frame old -> new correction.  Updates
    ``state.attr_rows`` in place and returns ``state``."""
    ts = _ts_used(state, mc)
    Rf, tf = pose_diff[:, :3, :3], pose_diff[:, :3, 3]
    # one quaternion per frame, then per point: the same rows as converting
    # every point's own gathered matrix
    dq = rotmat_to_quat(Rf)[ts]
    R, t = Rf[ts], tf[ts]
    pos = state.attr_rows[:, C_POS]
    positions = torch.einsum("nij,nj->ni", R, pos) + t
    orientations = quat_multiply(dq, state.attr_rows[:, C_QUAT])
    state.attr_rows[:, C_POS] = positions
    state.attr_rows[:, C_QUAT] = orientations
    state.attr_rows[mc.capacity] = attr_sentinel_row(state.attr_rows.device)
    return state


def recreate_hash(state: MapState, mc: MapConfig, cur_ts: int,
                  downsample_table_size: int = 1 << 21) -> MapState:
    """Rebuild the voxel hash from the current point positions, keeping per
    voxel the point whose timestamp is closest to ``cur_ts``."""
    dev = state.attr_rows.device
    cap = mc.capacity
    idx = torch.arange(cap + 1, dtype=torch.int64, device=dev)
    active = idx < state.count
    ts_diff = torch.abs(_ts_used(state, mc) - int(cur_ts)).to(torch.float32)
    pos = state.attr_rows[:, C_POS]
    keep = voxel_down_sample_min_value_mask(pos, active, mc.voxel_size, ts_diff,
                                            downsample_table_size)
    h = spatial_hash(grid_coords(pos, mc.voxel_size), mc.hash_size)
    slot = torch.where(keep, h, torch.full_like(h, mc.hash_size))
    table = torch.full((mc.hash_size + 1,), cap, dtype=torch.int64, device=dev)
    state.hash_table = scatter_set_last(table, slot,
                                        torch.where(keep, idx, torch.full_like(idx, cap)))
    return state


def finalize_map(state: MapState, mc: MapConfig, travel_dist: torch.Tensor, cur_ts: int,
                 prune_certainty_thre: float,
                 downsample_table_size: int = 1 << 21) -> MapState:
    """End-of-run map finalisation: merge duplicate neural points (one per
    voxel, the one whose timestamp is closest to ``cur_ts``), prune the
    inactive low-certainty ones, compact the survivors to the front of the
    buffer in index order and rebuild the hash over them.  Returns a new
    state; ``state`` is not modified."""
    dev = state.attr_rows.device
    cap = mc.capacity
    rows = torch.arange(cap + 1, dtype=torch.int64, device=dev)
    active = rows < state.count
    ts_diff = torch.abs(_ts_used(state, mc) - int(cur_ts)).to(torch.float32)
    keep_voxel = voxel_down_sample_min_value_mask(state.attr_rows[:, C_POS], active,
                                                  mc.voxel_size, ts_diff,
                                                  downsample_table_size)
    diff_travel = torch.abs(travel_dist[int(cur_ts)] - state.attr_rows[:, C_TRU])
    prune = (diff_travel > mc.travel_dist_window) \
        & (state.attr_rows[:, C_CERT] < prune_certainty_thre)
    keep = active & keep_voxel & ~prune

    perm = nonzero_static(keep, cap + 1, cap)
    count = torch.sum(keep)
    in_count = rows < count
    attr_rows = torch.where(in_count[:, None], state.attr_rows[perm],
                            attr_sentinel_row(dev)[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    geo_features = torch.where(in_count[:, None], state.geo_features[perm], zero)
    color_features = (torch.where(in_count[:, None], state.color_features[perm], zero)
                      if state.color_features is not None else None)
    h = spatial_hash(grid_coords(attr_rows[:, C_POS], mc.voxel_size), mc.hash_size)
    slot = torch.where(in_count, h, torch.full_like(h, mc.hash_size))
    table = torch.full((mc.hash_size + 1,), cap, dtype=torch.int64, device=dev)
    hash_table = scatter_set_last(table, slot,
                                  torch.where(in_count, rows, torch.full_like(rows, cap)))
    return MapState(attr_rows=attr_rows, geo_features=geo_features, count=count,
                    hash_table=hash_table, color_features=color_features)


# ----------------------------------------------------------------------
# states carried across from the JAX package (numpy arrays in)
# ----------------------------------------------------------------------


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _color_or_none(src, device):
    col = getattr(src, "color_features", None)
    return _t(col, torch.float32, device) if col is not None else None


def state_from_numpy(src, device=None) -> MapState:
    """A JAX ``MapState`` (or any object with its array attributes) -> MapState."""
    return MapState(attr_rows=_t(src.attr_rows, torch.float32, device),
                    geo_features=_t(src.geo_features, torch.float32, device),
                    count=_t(src.count, torch.int64, device),
                    hash_table=_t(src.hash_table, torch.int64, device),
                    color_features=_color_or_none(src, device))


def local_map_from_numpy(src, device=None) -> LocalMap:
    """A JAX ``LocalMap`` (or any object with its array attributes) -> LocalMap."""
    return LocalMap(indices=_t(src.indices, torch.int64, device),
                    attr_rows=_t(src.attr_rows, torch.float32, device),
                    geo_features=_t(src.geo_features, torch.float32, device),
                    count=_t(src.count, torch.int64, device),
                    member_mask=_t(src.member_mask, torch.bool, device),
                    lo1=_t(src.lo1, torch.int64, device),
                    lo2=_t(src.lo2, torch.int64, device),
                    origin=_t(src.origin, torch.float32, device),
                    hash_rows=_t(src.hash_rows, torch.float32, device),
                    color_features=_color_or_none(src, device))
