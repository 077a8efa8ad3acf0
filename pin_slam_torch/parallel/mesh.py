"""Data parallelism over ranks, torch counterpart of
``pin_slam_tpu/parallel/mesh.py``: the data mesh, the collectives the port
uses, the data-parallel SDF query (the mesher's grid queries), the plain
data-parallel training step, and the per-frame mapping loop with the batch
split over the ranks.

The JAX package shards a batch over a device mesh and lets XLA place the
``psum`` / ``all_gather``; the port runs one process per rank
(``distributed.py``), each with the whole replicated map and decoder, and
places the collectives itself.  The map, the decoder and Adam's state are
identical on every rank after every step: each all-reduce hands every rank
the same bits.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only,
under NCCL or gloo alike (gloo's ``all_gather`` of CUDA tensors, which
PyTorch's backend table does not list, runs and is exact with the torch of
the H100 machine: chip_smoke's two-process phases use it).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.ops import losses
from pin_slam_torch.slam import mapper as mp

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks: the process group (None: the default group), this
    process's index on the axis, the axis size, the rank's device, the
    global ranks in axis order, and the backend ("none" for a one-rank axis
    outside a process group, which runs no collective; a group of one rank
    runs its collectives, which copy)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    ranks: Tuple[int, ...]
    backend: str
    axis: str = DATA_AXIS

    @property
    def _group_order(self) -> List[int]:
        """Position in the group's own (ascending global rank) order of each
        axis index."""
        srt = sorted(self.ranks)
        return [srt.index(r) for r in self.ranks]


def single_mesh(device=None) -> Mesh:
    """The one-rank mesh (no process group)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=None, rank=0, size=1, device=dev, ranks=(0,), backend="none")


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The data mesh over the process group's ranks in rank order (the
    one-rank mesh without a group); raises unless the group has
    ``n_devices`` ranks.  ``distributed.make_global_mesh`` orders the ranks
    node-major instead."""
    from pin_slam_torch.parallel import distributed as pdist

    inf = pdist.info()
    if inf is None and (n_devices or 1) == 1:
        return single_mesh(device)
    inf = pdist.require_world(n_devices or inf.world, f"a data mesh of {n_devices} devices")
    return Mesh(group=None, rank=inf.rank, size=inf.world, device=inf.device,
                ranks=tuple(range(inf.world)), backend=inf.backend)


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the mesh (a new tensor)."""
    out = t.clone().contiguous()
    if mesh.backend != "none":
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def pmax(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    out = t.clone().contiguous()
    if mesh.backend != "none":
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t``, in axis order."""
    if mesh.backend == "none":
        return t[None].clone()
    is_bool = t.dtype == torch.bool
    x = (t.to(torch.uint8) if is_bool else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.stack([parts[g] for g in mesh._group_order])
    return out.to(torch.bool) if is_bool else out


def broadcast_object(mesh: Mesh, obj, src: int = 0):
    """Axis index ``src``'s Python object on every rank of the mesh."""
    if mesh.backend == "none":
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[src], group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def reduce_grads(mesh: Mesh, means: Sequence[torch.Tensor],
                 sums: Sequence[torch.Tensor] = ()) -> Tuple[List[torch.Tensor],
                                                            List[torch.Tensor]]:
    """One all-reduce of every tensor of ``means`` and ``sums`` (flattened
    into one buffer): the means over the mesh, and the sums."""
    if mesh.backend == "none":
        return list(means), list(sums)
    ts = list(means) + list(sums)
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, a = [], 0
    for i, t in enumerate(ts):
        part = flat[a:a + t.numel()].view(t.shape)
        a += t.numel()
        out.append(part / mesh.size if i < len(means) else part)
    return out[:len(means)], out[len(means):]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, replicas):
        ctx.mesh, ctx.replicas = mesh, replicas
        return all_gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        g = psum(ctx.mesh, g)[ctx.mesh.rank]
        return (g / ctx.replicas if ctx.replicas != 1 else g), None, None


def all_gather_grad(mesh: Mesh, x: torch.Tensor, replicas: int = 1) -> torch.Tensor:
    """``all_gather`` through which a gradient flows: the backward
    all-reduces the (size, ...) cotangent and slices out this rank's block
    (the transpose of a tiled all-gather, JAX's ``psum_scatter``).  When
    ``replicas`` ranks of the mesh run the same computation downstream of
    the gather (every rank of a map group merges the same candidates), each
    holds the whole cotangent; shard_map then hands each of them its
    ``1 / replicas`` share, and so does this."""
    return _AllGather.apply(x, mesh, replicas)


# ----------------------------------------------------------------------
# data-parallel query and training
# ----------------------------------------------------------------------


def _split(mesh: Mesh, n: int, what: str) -> slice:
    if n % mesh.size:
        raise ValueError(f"{what} {n} not divisible by {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def make_sharded_query(mesh: Mesh, mc: npts.MapConfig, offsets: torch.Tensor,
                       sdf_scale: float):
    """query(lm, decoder, pts) -> (sdf (B,), nn_count (B,)): every rank holds
    the whole (B, 3) batch and the replicated map and decoder, queries its
    B / size rows and gathers the rest (the mesher's grid queries)."""

    def query(lm, decoder, pts):
        sl = _split(mesh, pts.shape[0], "query batch")
        p = pts[sl]
        knn = npts.knn_search(lm, mc, p, offsets)
        feat, w, _ = npts.interpolate_features(lm, mc, p, knn.lidx)
        sdf, _ = decoder.blended_sdf(feat, w, mc.weighted_first, sdf_scale)
        return (all_gather(mesh, sdf).reshape(-1),
                all_gather(mesh, knn.nn_count).reshape(-1))

    return query


class ShardedBatch(NamedTuple):
    coord: torch.Tensor       # (B, 3) world-frame query / sample coordinates
    sdf_label: torch.Tensor   # (B,)
    weight: torch.Tensor      # (B,)
    valid: torch.Tensor       # (B,)


def make_sharded_train_step(mesh: Mesh, mc: npts.MapConfig, mcfg: mp.MapperConfig,
                            offsets: torch.Tensor):
    """The plain data-parallel SGD step on (local features, SDF decoder):
    step(lm, feats, heads, opt, batch) -> (feats, heads, opt, loss), with
    ``batch`` the whole replicated (B,) batch, of which each rank takes its
    B / size rows; ``heads`` a ``mapper.Heads`` and ``opt`` its
    ``mapper.init_opt_state``.  The loss is the whole batch's masked mean
    (each rank's sum over the valid rows of the whole batch); its gradients
    are summed over the ranks before the replicated Adam step."""

    def step(lm, feats, heads: mp.Heads, opt: mp.AdamState, batch: ShardedBatch):
        sl = _split(mesh, batch.coord.shape[0], "batch")
        coord, label, weight, valid = (x[sl] for x in batch)
        n_valid = torch.clamp(torch.sum(batch.valid), min=1).to(torch.float32)
        knn = npts.knn_search(lm, mc, coord, offsets)
        with torch.enable_grad():
            f = feats.detach().requires_grad_(True)
            ps = [p.detach().requires_grad_(True) for p in heads.leaves()]
            geo = mp._functional(heads.geo, ps)
            feat, w, _ = npts.interpolate_features(dataclasses.replace(lm, geo_features=f),
                                                   mc, coord, knn.lidx)
            if mc.weighted_first:
                pred = geo(feat)[..., 0] * mcfg.sdf_scale
            else:
                pred = torch.sum(geo(feat)[..., 0] * mcfg.sdf_scale * w, dim=-1)
            per = losses.sdf_bce_loss(pred, label, mcfg.sigma_sigmoid, weight,
                                      mcfg.loss_weight_on, valid=valid)
            # the masked mean over this rank's rows, rescaled to its share of
            # the whole batch's mean
            part = per * torch.clamp(torch.sum(valid), min=1).to(torch.float32) / n_valid
            grads = torch.autograd.grad(part, [f] + ps)
        _, g = reduce_grads(mesh, [], list(grads) + [part.detach()])
        loss = g.pop()
        new, opt = mp.adam_step(mcfg, [feats] + heads.leaves(), g, opt)
        return new[0], heads.with_leaves(new[1:]), opt, loss

    return step


class ShardedLoop:
    """The per-frame mapping loop with the batch split over the mesh: call it
    as ``mapper.mapping_loop_cached`` (or ``mapping_loop_autograd`` with
    ``autograd``) with this rank's ``batch_idx`` (T, mcfg.bs), drawn with
    the per-rank ``mcfg`` (``bs / size`` rows, ``max(1, bs_new_sample /
    size)`` of them new)."""

    def __init__(self, mesh: Mesh, mcfg: mp.MapperConfig, autograd: bool = False):
        self.mesh, self.mcfg, self.autograd = mesh, mcfg, autograd

    def __call__(self, lm, mc, feats, params, opt, pool, batch_idx, decoder_lr_scale,
                 after_pgo=False, color=None):
        loop = mp.mapping_loop_autograd if self.autograd else mp.mapping_loop_cached
        return loop(lm, mc, feats, params, opt, pool, self.mcfg, batch_idx, decoder_lr_scale,
                    after_pgo, color=color, mesh=self.mesh)


def make_sharded_mapping_loop(mesh: Mesh, mcfg: mp.MapperConfig,
                              autograd: bool = False) -> ShardedLoop:
    """The production per-frame training loop, data-parallel over ``mesh``:
    each rank trains on its own bs / size rows of the replicated pool, the
    gradients are averaged (the certainty sums summed, the newest frame id
    maxed) before the replicated Adam step; raises ``ValueError`` when the
    batch does not split evenly."""
    n = mesh.size
    if mcfg.bs % n:
        raise ValueError(f"bs {mcfg.bs} not divisible by {n} devices")
    return ShardedLoop(mesh, dataclasses.replace(
        mcfg, bs=mcfg.bs // n, bs_new_sample=max(1, mcfg.bs_new_sample // n)), autograd)
