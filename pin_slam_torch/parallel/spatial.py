"""The global map sharded across ranks, torch counterpart of
``pin_slam_tpu/parallel/spatial.py``.

Every voxel is owned by one map shard, ``shard_of(voxel) = owner_hash mod
S`` (primes decorrelated from the slot hash), and each rank of a map group
holds its own shard: the leading shard axis of the JAX package's stacked
arrays is the rank here.  A (data x map) mesh of ranks splits query and
training batches over its data axis.

* **Insert** needs no communication: every rank sees the replicated frame
  and masks it to its own voxels before the ordinary ``map_insert``.
* **Query** gathers candidates, not the map: each shard probes its own
  hash for the K neighbour cells, keeps its local top-k and contributes a
  payload row per candidate (position, quaternion, certainty, features);
  one ``all_gather`` over the map group, then the global top-k and the IDW
  blend run on every rank of the group alike.
* **Training**: each shard's feature table and the decoder are the
  trainables; the feature gradient returns to its owning shard through the
  autograd all-gather (``mesh.all_gather_grad``), and the decoder gradient
  is summed over the data group.

The live SLAM backend (``LiveBackend``) keeps the single-device local window
and shards only the global map: each shard builds its own window, one
``all_gather`` of the windows' blocks over the map group gives every rank the
same merged ``LocalMap``, whose global ids are shard-block encoded
(``g = shard * (cap_s + 1) + row``), and the tracker, the training loop,
the mesher and loop detection run on it unchanged.  The write-back, the
elastic deformation and the rehash run per shard, with no communication.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.neural_points import (
    ATTR_DIM, C_CERT, C_POS, C_TRC, _INVALID_DIST2, _SENTINEL_POS, MapConfig, MapState)
from pin_slam_torch.ops import losses
from pin_slam_torch.ops.hash3d import grid_coords, spatial_hash
from pin_slam_torch.ops.scatter import nonzero_static
from pin_slam_torch.ops.voxel import sqnorm3
from pin_slam_torch.parallel import mesh as pmesh
from pin_slam_torch.slam import mapper as mp

DATA_AXIS = "data"
MAP_AXIS = "map"

# ownership hash primes, decorrelated from ops.hash3d.PRIMES so that the
# shard of a voxel and its slot in the shard's table are independent
_OWNER_PRIMES = (2654435761, 805459861, 3674653429)
_MASK32 = 0xFFFFFFFF


def _mulmod32(a: torch.Tensor, p: int) -> torch.Tensor:
    """(a * p) mod 2^32 for a in [0, 2^32) (int64) and p < 2^32, in int64
    without overflow: the product is split at a's 16th bit."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * p + (((hi * p) & _MASK32) << 16)) & _MASK32


def shard_of(grid: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning map shard of each voxel, int32 grid [..., 3] -> int64 [...]:
    the JAX package's uint32 hash, wrapping mod 2^32."""
    g = grid.to(torch.int64) & _MASK32
    h = (_mulmod32(g[..., 0], _OWNER_PRIMES[0]) + _mulmod32(g[..., 1], _OWNER_PRIMES[1])) & _MASK32
    h = (h + _mulmod32(g[..., 2], _OWNER_PRIMES[2])) & _MASK32
    return h % n_shards


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A rank of a (data x map) mesh: its data group (the ranks of its map
    index, one per data index) and its map group (the ranks of its data
    index, one per map shard)."""
    data: pmesh.Mesh
    map: pmesh.Mesh

    @property
    def device(self) -> torch.device:
        return self.map.device


def make_mesh2d(n_data: int, n_map: int, device=None) -> Mesh2D:
    """Rank r is at (r // n_map, r % n_map), as the JAX package reshapes its
    devices.  Every rank creates every group, in one fixed order (the data
    groups, then the map groups), as ``new_group`` requires.  Without a
    process group a (1 x 1) mesh on ``device``; otherwise the group must
    have n_data * n_map ranks (else an error that names the launch)."""
    import torch.distributed as dist

    from pin_slam_torch.parallel import distributed as pdist

    need = n_data * n_map
    if pdist.info() is None and need == 1:
        one = pmesh.single_mesh(device)
        return Mesh2D(data=one, map=dataclasses.replace(one, axis=MAP_AXIS))
    inf = pdist.require_world(need, f"a {n_data} x {n_map} (data x map) mesh")
    d, m = divmod(inf.rank, n_map)

    def family(members):
        out = []
        for ranks in members:
            if len(ranks) == 1:
                out.append(None)
            elif len(ranks) == inf.world:
                out.append("world")
            else:
                out.append(dist.new_group(ranks=list(ranks)))
        return out

    data_members = [tuple(dd * n_map + mm for dd in range(n_data)) for mm in range(n_map)]
    map_members = [tuple(d_ * n_map + mm for mm in range(n_map)) for d_ in range(n_data)]
    data_groups, map_groups = family(data_members), family(map_members)

    def axis_mesh(group, ranks, index, axis):
        return pmesh.Mesh(group=None if group in (None, "world") else group, rank=index,
                          size=len(ranks), device=inf.device, ranks=ranks,
                          backend=inf.backend if len(ranks) > 1 else "none", axis=axis)

    return Mesh2D(data=axis_mesh(data_groups[m], data_members[m], d, DATA_AXIS),
                  map=axis_mesh(map_groups[d], map_members[d], m, MAP_AXIS))


def shard_config(mc: MapConfig, n_map: int) -> MapConfig:
    """Per-shard MapConfig: capacity and hash table split across shards."""
    return dataclasses.replace(mc, capacity=max(1, mc.capacity // n_map),
                               hash_size=max(2, mc.hash_size // n_map))


def init_sharded_map(mesh: Mesh2D, smc: MapConfig) -> MapState:
    """This rank's shard of the map: an empty per-shard MapState."""
    return npts.init_map_state(smc, mesh.device)


def make_sharded_insert(mesh: Mesh2D, smc: MapConfig, downsample_table_size: int = 1 << 20):
    """insert(state, points, valid, cur_ts, travel_dist) -> state: the
    replicated points masked to this shard's voxels, then the ordinary
    ``map_insert`` (no communication)."""
    n_map, s = mesh.map.size, mesh.map.rank

    def insert(state, points, valid, cur_ts, travel_dist):
        own = shard_of(grid_coords(points, smc.voxel_size), n_map) == s
        return npts.map_insert(state, smc, points, valid & own, cur_ts, travel_dist,
                               downsample_table_size=downsample_table_size)

    return insert


def _payload_dim(smc: MapConfig) -> int:
    """A candidate's payload row: [pos (3), quat (4), cert (1), feat (F)]."""
    return 8 + smc.feature_dim


def _local_candidates(state: MapState, smc: MapConfig, points: torch.Tensor,
                      offsets: torch.Tensor, travel_now, features: Optional[torch.Tensor] = None):
    """This shard's hash probe and local top-k, with the travel-distance
    neighbour filter in the query.  ``features`` replaces
    ``state.geo_features`` (a leaf the gradient flows to).  Returns
    (payload (B, k, 8 + F), dist2 (B, k), valid (B, k), nn_count (B,))."""
    cap = smc.capacity
    feats_tab = state.geo_features if features is None else features
    grid = grid_coords(points, smc.voxel_size)
    cells = grid[:, None, :] + offsets[None, :, :].to(grid.dtype)
    gidx = state.hash_table[spatial_hash(cells, smc.hash_size)]          # (B, K), cap = empty
    rows = state.attr_rows[gidx]
    dist2 = sqnorm3(rows[..., C_POS] - points[:, None, :])
    in_window = torch.abs(travel_now - rows[..., C_TRC]) < smc.travel_dist_window
    valid = (gidx < cap) & (dist2 <= smc.max_valid_dist2) & in_window
    dist2 = torch.where(valid, dist2, torch.full_like(dist2, _INVALID_DIST2))
    nn_count = torch.sum(valid, dim=-1)

    k = min(smc.nn_k, offsets.shape[0])
    sel = npts.exact_k_min(dist2, k)
    kidx = torch.gather(gidx, 1, sel)
    kvalid = torch.gather(valid, 1, sel)
    kdist2 = torch.gather(dist2, 1, sel)
    safe = torch.where(kvalid, kidx, torch.full_like(kidx, cap))
    payload = torch.cat([state.attr_rows[safe][..., :8],
                         torch.where(kvalid[..., None], feats_tab[safe],
                                     torch.zeros_like(feats_tab[safe]))], -1)
    # an invalid candidate carries the sentinel position, so the merged
    # top-k and the IDW weights reject it by its distance alone
    sentinel = torch.zeros((_payload_dim(smc),), dtype=torch.float32, device=points.device)
    sentinel[:3] = _SENTINEL_POS
    sentinel[3] = 1.0
    payload = torch.where(kvalid[..., None], payload, sentinel)
    return payload, kdist2, kvalid, nn_count


def _merge_and_blend(points: torch.Tensor, payload: torch.Tensor, dist2: torch.Tensor,
                     valid: torch.Tensor, smc: MapConfig):
    """Global top-k over the gathered (B, S * k) candidates and the IDW
    blend, differentiable in the payload's features.  Returns (geo_feat
    (B, F + 3) or (B, k, F + 3), weights (B, k), certainty (B,))."""
    k = min(smc.nn_k, dist2.shape[-1])
    sel = npts.exact_k_min(dist2, k)
    pay = torch.gather(payload, 1, sel[..., None].expand(-1, -1, payload.shape[-1]))
    vld = torch.gather(valid, 1, sel)
    cert = pay[..., C_CERT]
    feats = torch.where(vld[..., None], pay[..., 8:], torch.zeros_like(pay[..., 8:]))
    vec = points[:, None, :] - pay[..., 0:3]
    d2 = torch.where(vld, sqnorm3(vec), torch.full_like(vec[..., 0], _INVALID_DIST2))
    vec = torch.where(vld[..., None], vec, torch.zeros_like(vec))
    _, _, w = npts.idw_weights(d2, vld, smc.idw_eps)
    geo_vec = torch.cat([feats, vec], dim=-1)
    geo_out = torch.sum(geo_vec * w[..., None], dim=1) if smc.weighted_first else geo_vec
    certainty = torch.sum(torch.where(vld, cert, torch.zeros_like(cert)) * w, dim=-1)
    return geo_out, w, certainty


def _gather_candidates(mesh: Mesh2D, payload, dist2, valid, grad: bool = False):
    """The map group's candidates side by side: (B, S * k, ...), shard-major."""
    n = mesh.map.size
    B, k = dist2.shape
    gp = (pmesh.all_gather_grad(mesh.map, payload, replicas=n) if grad
          else pmesh.all_gather(mesh.map, payload))
    gd = pmesh.all_gather(mesh.map, torch.stack([dist2, valid.to(torch.float32)]))
    return (gp.permute(1, 0, 2, 3).reshape(B, n * k, -1),
            gd[:, 0].permute(1, 0, 2).reshape(B, n * k),
            gd[:, 1].permute(1, 0, 2).reshape(B, n * k) > 0.5)


def _data_slice(mesh: Mesh2D, n: int) -> slice:
    if n % mesh.data.size:
        raise ValueError(f"batch {n} not divisible by {mesh.data.size} data ranks")
    per = n // mesh.data.size
    return slice(mesh.data.rank * per, (mesh.data.rank + 1) * per)


def _decode(geo, feat, w, smc: MapConfig, sdf_scale: float):
    out = geo(feat)[..., 0] * sdf_scale
    return out if smc.weighted_first else torch.sum(out * w, dim=-1)


def make_spatial_query(mesh: Mesh2D, smc: MapConfig, offsets: torch.Tensor, sdf_scale: float):
    """query(state, decoder, points, travel_now) -> (sdf (B,), nn_count (B,)):
    ``points`` the whole replicated batch, of which each data rank queries
    B / n_data rows; one all-gather of candidate payloads over the map
    group, the neighbour counts summed over it, and the data ranks' rows
    gathered, so that every rank returns the whole batch's result."""

    def query(state, decoder, points, travel_now):
        p = points[_data_slice(mesh, points.shape[0])]
        payload, dist2, valid, nn = _local_candidates(state, smc, p, offsets, travel_now)
        payload, dist2, valid = _gather_candidates(mesh, payload, dist2, valid)
        nn = pmesh.psum(mesh.map, nn)
        geo_feat, w, _ = _merge_and_blend(p, payload, dist2, valid, smc)
        sdf = _decode(decoder, geo_feat, w, smc, sdf_scale)
        return (pmesh.all_gather(mesh.data, sdf).reshape(-1),
                pmesh.all_gather(mesh.data, nn).reshape(-1))

    return query


class SpatialTrainables(NamedTuple):
    features: torch.Tensor    # (cap_s + 1, F): this rank's shard
    heads: mp.Heads           # the SDF decoder, replicated


class SpatialBatch(NamedTuple):
    coord: torch.Tensor       # (B, 3), the whole batch (each data rank takes its rows)
    sdf_label: torch.Tensor   # (B,)
    weight: torch.Tensor      # (B,)
    valid: torch.Tensor       # (B,)
    travel_now: float


def spatial_loss_and_grads(mesh: Mesh2D, smc: MapConfig, offsets: torch.Tensor,
                           state: MapState, tr: SpatialTrainables, batch: SpatialBatch, *,
                           sigma_sigmoid: float, sdf_scale: float, loss_weight_on: bool):
    """The whole batch's SDF BCE loss (its masked mean) through the sharded
    query and its gradients: (loss, d loss / d this shard's features,
    [d loss / d decoder leaf]).  Each data rank's share of the loss is its
    rows' sum over the whole batch's valid count; the feature gradient
    reaches its owning shard through the candidates' autograd all-gather
    and is summed over the data group, as is the decoder gradient."""
    sl = _data_slice(mesh, batch.coord.shape[0])
    p, label, weight, valid = (x[sl] for x in batch[:4])
    n_valid = torch.clamp(torch.sum(batch.valid), min=1).to(torch.float32)
    with torch.enable_grad():
        f = tr.features.detach().requires_grad_(True)
        ps = [q.detach().requires_grad_(True) for q in tr.heads.leaves()]
        payload, dist2, vld, _ = _local_candidates(state, smc, p, offsets, batch.travel_now,
                                                   features=f)
        payload, dist2, vld = _gather_candidates(mesh, payload, dist2, vld, grad=True)
        geo_feat, w, _ = _merge_and_blend(p, payload, dist2, vld, smc)
        pred = _decode(mp._functional(tr.heads.geo, ps), geo_feat, w, smc, sdf_scale)
        part = losses.sdf_bce_loss(pred, label, sigma_sigmoid, weight, loss_weight_on,
                                   valid=valid)
        part = part * torch.clamp(torch.sum(valid), min=1).to(torch.float32) / n_valid
        grads = torch.autograd.grad(part, [f] + ps)
    _, red = pmesh.reduce_grads(mesh.data, [], list(grads) + [part.detach()])
    return red[-1], red[0], red[1:-1]


def make_spatial_train_step(mesh: Mesh2D, smc: MapConfig, offsets: torch.Tensor, *,
                            lr: float, adam_eps: float, sigma_sigmoid: float,
                            sdf_scale: float, loss_weight_on: bool):
    """The spatially sharded SGD step on (this shard's features, decoder):
    (step, init_opt) with step(state, trainables, opt, batch) -> (trainables,
    opt, loss) and Adam(b1 0.9, b2 0.99, ``adam_eps``) in optax's order."""

    def init_opt(tr: SpatialTrainables) -> List[mp.OptaxAdam]:
        return [mp.OptaxAdam(x, lr, adam_eps) for x in [tr.features] + tr.heads.leaves()]

    def step(state, tr: SpatialTrainables, opt: List[mp.OptaxAdam], batch: SpatialBatch):
        loss, g_f, g_h = spatial_loss_and_grads(
            mesh, smc, offsets, state, tr, batch, sigma_sigmoid=sigma_sigmoid,
            sdf_scale=sdf_scale, loss_weight_on=loss_weight_on)
        leaves = [tr.features] + tr.heads.leaves()
        new = [x + o.update(g) for x, o, g in zip(leaves, opt, [g_f] + g_h)]
        return SpatialTrainables(new[0], tr.heads.with_leaves(new[1:])), opt, loss

    return step, init_opt


# ----------------------------------------------------------------------
# the live SlamSystem backend: the global map sharded over the map group,
# the bounded local window merged and replicated
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ShardWindow:
    """This shard's own local window and every shard's window count, from
    the ``extract`` that built the merged window (the write-back slices
    this shard's rows out of the merged ones with them)."""
    lm: npts.LocalMap
    counts: torch.Tensor      # (S,) int64


class LiveBackend:
    """The sharded-global-map backend of ``SlamSystem`` (``map_shards > 1``).

    ``mc_user`` is the single-device MapConfig the configuration describes;
    each shard holds 1 / S of its capacity, hash table and local window.
    ``mc_merged`` (capacity ``S * (cap_s + 1) - 1`` for the shard-block
    encoded global ids, local capacity ``S * L_s``) is what every consumer
    of the merged window uses.  Shard-block ids ride float32 value casts in
    the local hash rows and the pool's kNN cache, so ``mc_merged``'s
    capacity must stay within 2^24."""

    def __init__(self, mesh: Mesh2D, mc_user: MapConfig, downsample_table_size: int = 1 << 20,
                 insert_bucket: int = 1 << 14):
        self.mesh, n = mesh.map, mesh.map.size
        self.n_map = n
        self.device = mesh.device
        self.smc = smc = dataclasses.replace(
            mc_user, capacity=max(1, mc_user.capacity // n),
            hash_size=max(2, mc_user.hash_size // n),
            local_capacity=max(1, mc_user.local_capacity // n))
        self.cs1 = smc.capacity + 1
        self.merged_cap = n * self.cs1 - 1
        if self.merged_cap > (1 << 24):
            raise ValueError(
                f"map_shards={n}: merged capacity {self.merged_cap} (map_capacity + "
                f"map_shards - 1) exceeds 2^24; shard-block global ids would lose exactness "
                f"in float32 casts: reduce map_capacity or map_shards")
        self.Lm = n * smc.local_capacity
        self.mc_merged = dataclasses.replace(mc_user, capacity=self.merged_cap,
                                             local_capacity=self.Lm)
        self.downsample_table_size = downsample_table_size
        self.insert_bucket = insert_bucket

    def init_state(self) -> MapState:
        return npts.init_map_state(self.smc, self.device)

    def insert(self, state: MapState, points, valid, cur_ts: int, travel) -> MapState:
        """This shard's voxels of the frame's candidates, inserted with a
        per-call bucket that may lie far below the frame's width: each shard
        keeps ~1 / S of the survivors, and ``map_insert``'s whole-bucket room
        guard (count <= cap - bucket) then lets it fill close to its
        capacity."""
        own = shard_of(grid_coords(points, self.smc.voxel_size), self.n_map) == self.mesh.rank
        return npts.map_insert(state, self.smc, points, valid & own, cur_ts, travel,
                               downsample_table_size=self.downsample_table_size,
                               insert_bucket=min(points.shape[0], self.insert_bucket,
                                                 self.smc.capacity))

    def extract(self, state: MapState, origin, cur_ts: int, travel,
                travel_window: Optional[float] = None):
        """(ShardWindow, merged LocalMap): each shard's window
        (``build_local_map``), one all-gather of the windows' rows with
        their shard-block ids over the map group, and the merged window in
        ascending id order (shard-major), the first ``S * L_s`` members kept
        when it overflows."""
        smc, n, cs1, Lm = self.smc, self.n_map, self.cs1, self.Lm
        Ls, F = smc.local_capacity, smc.feature_dim
        dev = self.device
        lm_s = npts.build_local_map(state, smc, origin, cur_ts, travel,
                                    travel_window=travel_window)
        gidx = torch.where(lm_s.indices < smc.capacity, self.mesh.rank * cs1 + lm_s.indices,
                           torch.full_like(lm_s.indices, self.merged_cap))
        parts = [lm_s.attr_rows, lm_s.geo_features]
        if lm_s.color_features is not None:
            parts.append(lm_s.color_features)
        block = torch.cat(parts + [gidx.to(torch.float32)[:, None]], 1)
        g = pmesh.all_gather(self.mesh, block)                           # (S, Ls + 1, W)
        gid = g[..., -1].to(torch.int64)
        counts = torch.sum(gid < self.merged_cap, dim=1)

        nrow = n * (Ls + 1)
        active = (torch.arange(Ls + 1, device=dev)[None, :] < counts[:, None]).reshape(-1)
        rankf = torch.cumsum(active.to(torch.int64), 0) - 1
        # keep-first trim: members are kept shard-major (all of shard 0 before
        # any of shard 1) when the merged window overflows S * L_s
        active = active & (rankf < Lm)
        j = torch.cat([nonzero_static(active, Lm, nrow),
                       torch.full((1,), nrow, dtype=torch.int64, device=dev)])
        sentinel = torch.cat([npts.attr_sentinel_row(dev),
                              torch.zeros((g.shape[-1] - ATTR_DIM - 1,), device=dev),
                              torch.full((1,), float(self.merged_cap), device=dev)])
        rows = torch.cat([g.reshape(nrow, -1), sentinel[None]])[j]      # (Lm + 1, W)
        indices = rows[:, -1].to(torch.int64)
        attr = rows[:, :ATTR_DIM].contiguous()
        geo = rows[:, ATTR_DIM:ATTR_DIM + F].contiguous()
        col = (rows[:, ATTR_DIM + F:ATTR_DIM + 2 * F].contiguous()
               if lm_s.color_features is not None else None)
        count = torch.clamp(torch.sum(counts), max=Lm)
        mm = torch.zeros((self.merged_cap + 1,), dtype=torch.bool, device=dev)
        mm[indices] = True
        mm[self.merged_cap] = False
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        merged = npts.LocalMap(
            indices=indices, attr_rows=attr, geo_features=geo, count=count, member_mask=mm,
            lo1=zero, lo2=zero.clone(), origin=origin.to(torch.float32).clone(),
            hash_rows=npts._pack_hash_rows(self.mc_merged, attr[:, C_POS], count, indices),
            color_features=col)
        return ShardWindow(lm=lm_s, counts=counts), merged

    def writeback(self, state: MapState, win: ShardWindow, m_attr, m_geo, m_col,
                  travel) -> MapState:
        """The trained merged rows back into this shard: its members occupy
        one contiguous range of the merged rows (ids are shard-major), so it
        slices that range and runs the ordinary ``assign_local_to_global``
        (no communication)."""
        smc, Lm = self.smc, self.Lm
        Ls = smc.local_capacity
        lm_s, dev = win.lm, self.device
        start = torch.sum(win.counts[:self.mesh.rank])
        n_in = torch.minimum(torch.clamp(Lm - start, min=0), lm_s.count)    # merged-overflow trim
        rank_s = torch.cumsum(lm_s.member_mask.to(torch.int64), 0) - 1
        mm2 = lm_s.member_mask & (rank_s < n_in)
        rows = torch.clamp(start, max=Lm) + torch.arange(Ls + 1, device=dev)

        def take(m):
            pad = torch.cat([m, torch.zeros((Ls, m.shape[1]), dtype=m.dtype, device=dev)])
            return pad[rows]

        lm_w = dataclasses.replace(
            lm_s, attr_rows=take(m_attr), geo_features=take(m_geo),
            color_features=take(m_col) if m_col is not None else None, member_mask=mm2)
        return npts.assign_local_to_global(state, lm_w, smc, travel)

    def adjust(self, state: MapState, pose_diff) -> MapState:
        """The elastic deformation of this shard's points (each moves by its
        own timestamp's pose correction).  A point keeps its shard: one moved
        across an ownership boundary stays findable through the merged
        window, and a new point in its voxel inserts into the other shard, a
        cross-shard duplicate of the kind the rehash keeps anyway."""
        return npts.adjust_map(state, self.smc, pose_diff)

    def recreate(self, state: MapState, cur_ts: int) -> MapState:
        return npts.recreate_hash(state, self.smc, cur_ts,
                                  downsample_table_size=self.downsample_table_size)

    def map_count(self, state: MapState) -> int:
        """The points of every shard (one all-reduce)."""
        return int(pmesh.psum(self.mesh, state.count))

    def _gather_rows(self, state: MapState, tables):
        """(S, max count, W): every shard's first rows of ``tables``
        side by side, and the shards' counts."""
        counts = pmesh.all_gather(self.mesh, state.count.reshape(1)).reshape(-1)
        top = int(torch.max(counts))
        block = torch.cat([t[:top] for t in tables], 1)
        if block.shape[0] < top:
            block = torch.cat([block, block.new_zeros((top - block.shape[0], block.shape[1]))])
        return pmesh.all_gather(self.mesh, block), counts

    def gather_attr_rows(self, state: MapState) -> torch.Tensor:
        """Every shard's attribute rows in the shard-block id layout
        ((S * (cap_s + 1), 16); rows past a shard's count are sentinel
        rows): what the pool's kNN-cache refresh reads after a deformation."""
        g, counts = self._gather_rows(state, [state.attr_rows])
        out = npts.attr_sentinel_row(self.device).expand(self.n_map * self.cs1, ATTR_DIM).clone()
        top = g.shape[1]
        for s in range(self.n_map):
            out[s * self.cs1:s * self.cs1 + top] = g[s]
            out[s * self.cs1 + int(counts[s]):(s + 1) * self.cs1] = npts.attr_sentinel_row(
                self.device)
        return out

    def gather_state_dense(self, state: MapState):
        """Every shard's points, compacted on the host: (positions,
        attribute rows, features, colour features or None, shard-block ids,
        total count), shard by shard, for the artifacts at the end of a
        run."""
        tables = [state.attr_rows, state.geo_features]
        if state.color_features is not None:
            tables.append(state.color_features)
        g, counts = self._gather_rows(state, tables)
        g, counts = g.cpu().numpy(), counts.cpu().numpy()
        F = state.geo_features.shape[1]
        rows = np.concatenate([g[s, :int(counts[s])] for s in range(self.n_map)])
        ids = np.concatenate([np.arange(s * self.cs1, s * self.cs1 + int(counts[s]))
                              for s in range(self.n_map)]).astype(np.int32)
        col = rows[:, ATTR_DIM + F:] if state.color_features is not None else None
        return (rows[:, :3], rows[:, :ATTR_DIM], rows[:, ATTR_DIM:ATTR_DIM + F], col, ids,
                int(counts.sum()))
