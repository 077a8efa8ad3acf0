"""The per-frame SLAM loop, torch counterpart of
``pin_slam_tpu/slam/pipeline.py``: odometry, mapping, with ``pgo_on``
loop closure, pose-graph optimisation and elastic map deformation, and with
``ba_freq_frame > 0`` sliding-window bundle adjustment.

Per frame: odometry (source voxel-downsample + ``track_frame``), then the map
update (voxel mask -> ``sample_rays`` -> ``map_insert`` ->
``build_local_map`` -> new-region flags -> ``append_knn`` -> ``pool_append``),
then ``cfg.iters`` Adam iterations of ``mapping_loop_cached`` and the
write-back ``assign_local_to_global``.  Stop frames run a reduced training on
the existing pool (``stop_train``); frame 0 runs ``init_iter_ratio - 1``
extra training chunks (``extra_train``).

With ``pgo_on`` every frame adds a node and an odometry factor to the pose
graph and a scan-context descriptor of the PRE-update local map to the loop
detector.  Every ``pgo_freq`` frames (detection frames) the pose books are
settled before the map update: local (pose-distance) then global
(scan-context) loop detection, verification by registering the frame's
source cloud against the map rebuilt around the loop frame, and on success
pose-graph optimisation, map deformation (``adjust_map``, ``recreate_hash``)
and the pool's re-derivation (``pool_kernel.pool_pass``).
From then on (``after_pgo``) every offset vector is rotated into its
neighbour's frame.

Every ``ba_freq_frame`` frames (once past half of ``ba_frame``) bundle
adjustment refines the last ``ba_frame`` poses (of the pose graph when PGO
is on) and the local features jointly on the pool's surface samples, before
the map update, then re-derives the pool's coordinates and cached geometry.

With ``color_on`` (the RGB-D profile) a colour head rides along: the
frame's colours go with its points into the source cloud (the tracker's
intensity-consistency weight or photometric rows) and the samples (the
pool's colour labels), the training loop trains the colour features and
the colour decoder beside the geometry, the saved map holds both, and the
mesh's vertices are painted.

With ``semantic_on`` (the SemanticKITTI profile) each frame's learning
classes go with its points into the samples (the pool's class column), a
semantic decoder shares the geometry's features, and the mesh's vertices
get its classes.  The semantic head, and SDF decoders other than one hidden
layer with biases, train by torch autograd (``mapper.mapping_loop_autograd``)
instead of the training kernels, as the JAX package trains them by
autodiff.  With ``estimate_normal`` the source cloud's normals weight the
tracker's rows (odometry and loop verification); with ``dynamic_filter_on``
a frame's points in confidently observed free space (the certainty of the
map around them at least ``dynamic_certainty_thre``, their SDF at least
``dynamic_sdf_ratio_thre`` voxels) stay out of the map.

With ``pos_encoding_band`` the offset vectors are encoded (NeRF or
Gaussian features) wherever the map is queried or trained, the pool rows
and the decoders widen with them, and the tracker takes its autograd path.
The pool rows hold ``query_nn_k`` neighbours.  Under
``PIN_SLAM_EXACT_KNN=1`` every training call runs the uncached
``mapper.mapping_loop`` (a fresh kNN per batch, every head by autograd),
which also trains ``layer_norm_on``; the cached loop refuses it.  The
colour head beside the semantic head, or beside an SDF decoder outside the
kernels, trains in the cached autograd loop.

With ``o3d_vis_on`` (or a ``mesh_now`` request) the run writes in-run
artifacts under ``<run>/vis`` (local-map meshes and SDF slices at their
cadences) and refreshes a live ``viewer.html``; before every frame it reads
its control file ``<run>/control.json`` (pause, step, mesh now, pause at
the next loop closure, the in-run mesher's resolution), which
``utils/viewer_server.py`` writes from the viewer's buttons.

With ``dp_devices > 1`` (launched as that many processes, ``parallel/
distributed.py``) every rank runs this loop on the same frames and each
training call splits its batch over the ranks (``parallel/mesh.py``): the
gradients are averaged before the replicated Adam step, and the mesher's
grid queries are split likewise.  With ``map_shards > 1`` the global map is
sharded over the ranks (``parallel/spatial.py``): each frame's insert goes
to the owning shards, and the local window every consumer reads is merged
from the shards' windows.  Either way the pose books, the pool and the
decoders stay bit-identical on every rank, and rank 0 alone writes the run
directory.

The JAX package fuses each stage into one jitted program; the port runs the
same operations eagerly on the device, with the pose hand-over and the
health-gate decisions on the host.  Every random draw comes from one
``RandomSource`` (a ``torch.Generator`` on the device); tests substitute the
JAX package's draws.

At the end of a run (``run`` -> ``save_artifacts``) the map is finalised
(merged and pruned) and, as the configuration asks, saved (``pin_map.npz``,
``neural_points.ply``), the merged point cloud written, and the whole map
meshed chunk by chunk on the device (``mesh/mesh.ply``); a self-contained
``viewer.html`` is written last.

Options this slice does not port raise ``NotImplementedError`` pointing at
ROADMAP.md; none is ignored silently.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from pin_slam_torch.dataset import io as pio
from pin_slam_torch.dataset.slam_dataset import Frame, SLAMDataset
from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.decoder import Decoder
from pin_slam_torch.ops import pool_kernel
from pin_slam_torch.ops.marching_cubes import vertex_normals
from pin_slam_torch.ops.normals import estimate_normals
from pin_slam_torch.ops.sampler import SamplerConfig, draw_ray_noise, sample_rays
from pin_slam_torch.ops.scatter import nonzero_static
from pin_slam_torch.ops.transforms import np_se3_inverse, se3_expmap
from pin_slam_torch.ops.voxel import voxel_down_sample_mask
from pin_slam_torch.slam import loop_detector as ld
from pin_slam_torch.slam import mapper as mp
from pin_slam_torch.slam import pgo as pgo_mod
from pin_slam_torch.slam import tracker as trk
from pin_slam_torch.slam.mesher import Mesher, MesherConfig, split_chunks
from pin_slam_torch.utils import sensor_cad, tracing, wandb_log
from pin_slam_torch.utils.experiment import save_implicit_map
from pin_slam_torch.utils.platform import not_ported, resolve_device
from pin_slam_torch.utils.viewer_html import export_html

TS_CAPACITY = 1 << 16
# the stage spans behind ``SlamSystem.stage_times``' columns
STAGE_SPANS = ("upload", "odometry", "map_update", "training", "pgo")


def exact_knn_on() -> bool:
    """``PIN_SLAM_EXACT_KNN=1``: train with the uncached ``mapper.mapping_loop``
    (a fresh kNN per batch), as the JAX package does under the variable."""
    return os.environ.get("PIN_SLAM_EXACT_KNN", "0") == "1"


def check_ported(cfg) -> None:
    """Raise for every option this slice of the port does not cover, and for
    the combinations the JAX package refuses (``ValueError``)."""
    if cfg.map_shards > 1:
        if cfg.dp_devices > 1:
            raise ValueError("map_shards > 1 requires dp_devices == 1 (the data and map "
                             "axes are not composed; parallel/spatial.py)")
        if cfg.ba_freq_frame > 0:
            raise ValueError("map_shards > 1 requires ba_freq_frame=0 (bundle adjustment's "
                             "joint pose and feature refinement is not sharded; PGO and "
                             "the elastic deformation are)")
    # data parallelism takes precedence over PIN_SLAM_EXACT_KNN, as in the JAX package
    exact = exact_knn_on() and cfg.dp_devices <= 1
    unported = [
        # the JAX package's cached loop trains raw features while its
        # queries normalise them; only its uncached loop trains what they read
        ("layer_norm_on on the cached training path (ROADMAP C 14; trained under "
         "PIN_SLAM_EXACT_KNN=1)", cfg.layer_norm_on and not exact),
        # knobs the JAX package measured and rejected (PERF_TPU.md); kept
        # there at their defaults, not carried into the port
        ("fresh_freespace_damp < 1.0", cfg.fresh_freespace_damp < 1.0),
        ("probe_dedup_near_budget > 0", cfg.probe_dedup_near_budget > 0)]
    for name, on in unported:
        if on:
            raise not_ported(name)


class RandomSource:
    """Every random draw of the main path, from one ``torch.Generator``.

    With ``rank`` (data parallelism) the training batches come from a
    generator of the rank's own, seeded from (seed, rank), and the shared
    generator advances identically on every rank."""

    def __init__(self, seed: int, device: torch.device, rank: Optional[int] = None):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.batch_gen = self.gen
        if rank is not None:
            self.batch_gen = torch.Generator(device=device)
            self.batch_gen.manual_seed(int(np.random.SeedSequence(
                [int(seed), int(rank)]).generate_state(1)[0]))

    def ray_noise(self, frame_id: int, sc: SamplerConfig, n: int):
        return draw_ray_noise(self.gen, sc, n, self.device)

    def batch_indices(self, frame_id: int, chunk: int, pool: mp.PoolState,
                      mcfg: mp.MapperConfig, use_new: bool, num_iters: int):
        """chunk -1: the frame's main training, -2: a stop frame's training,
        0..: frame-0 extra chunks (tests key the JAX package's draws on it)."""
        return mp.sample_batch_indices(self.batch_gen, pool, mcfg,
                                       tracing.upload(use_new, "use_new", self.device),
                                       num_iters)

    def ba_indices(self, frame_id: int, pool: mp.PoolState, bs: int, num_iters: int):
        """Bundle adjustment's (num_iters, bs) pool rows, uniform over the
        filled pool (tests key the JAX package's draws on the frame)."""
        fill = torch.clamp(pool.fill, min=1)
        u = torch.rand((num_iters, bs), generator=self.gen, device=self.device,
                       dtype=torch.float64)
        return torch.minimum((u * fill).to(torch.int64), fill - 1)


class SlamSystem:
    """Owns the device state and the host pose books; one frame at a time.

    ``device=None`` runs on the GPU (and raises if there is none); pass
    ``device="cpu"`` to run the kernels' plain PyTorch versions on the CPU.
    ``dp_devices > 1`` and ``map_shards > 1`` need a process group of that
    many ranks (``parallel.distributed.initialize``), each on the device
    the group gave it; without one they raise, naming the launch.

    ``stage_times`` holds a row a frame, in seconds, of its five stage spans
    (``STAGE_SPANS``: upload, odometry, map update, training, pgo; the
    odometry column leaves out the back end's work before the map update,
    the training column the pose graph's bookkeeping after it).  With
    ``sync_stages`` (on the GPU) every stage ends in a synchronise, so a
    column is the stage's device time as well; without it a column is host
    time: what the host enqueued plus what it waited for in counted reads,
    not device time."""

    def __init__(self, config, dataset: Optional[SLAMDataset] = None,
                 device=None, random_source: Optional[RandomSource] = None,
                 sync_stages: bool = False):
        cfg = self.config = config
        check_ported(cfg)
        self.exact_knn = exact_knn_on() and cfg.dp_devices <= 1
        self.device = dev = resolve_device(device)
        self.dp_mesh, self._spatial, self._slms, self._dense = None, None, None, False
        ranks = None                   # the mesh whose ranks keep replicas in step
        if cfg.dp_devices > 1:
            from pin_slam_torch.parallel import distributed as pdist

            self.dp_mesh = ranks = pdist.make_global_mesh(cfg.dp_devices)
        elif cfg.map_shards > 1:
            from pin_slam_torch.parallel import spatial as psp

            mesh2d = psp.make_mesh2d(1, cfg.map_shards)
            ranks = mesh2d.map
        if ranks is not None:
            if ranks.device.type != dev.type:
                raise RuntimeError(f"the process group's ranks run on {ranks.device}, "
                                   f"the system was asked for {dev}")
            self.device = dev = ranks.device
        self._ranks = ranks
        self.is_writer = ranks is None or ranks.ranks[ranks.rank] == 0
        self.dataset = dataset if dataset is not None else SLAMDataset(cfg, device=dev)
        if self.dataset.device is None:
            self.dataset.device = dev
        self.mc = npts.MapConfig.from_config(cfg)
        if cfg.map_shards > 1:
            # per-shard insert bucket: big enough that frame 0 (every candidate
            # new, ownership splitting them ~1 / shards) never truncates, small
            # enough that map_insert's room guard lets a shard fill to ~cap / 2
            shard_cap = cfg.map_capacity // cfg.map_shards
            self._spatial = psp.LiveBackend(
                mesh2d, self.mc, downsample_table_size=cfg.downsample_hash_size,
                insert_bucket=max(256, min(cfg.frame_bucket, shard_cap // 2)))
            self.mc = self._spatial.mc_merged
        self.mcfg = mp.MapperConfig.from_config(cfg)
        self.sc = SamplerConfig.from_config(cfg)
        self.tc = trk.TrackerConfig.from_config(cfg)
        # data parallelism: each rank trains on bs / dp_devices rows a call
        self._dp_loop = None
        if self.dp_mesh is not None:
            from pin_slam_torch.parallel import mesh as pmesh

            self._dp_loop = pmesh.make_sharded_mapping_loop(self.dp_mesh, self.mcfg)
        self.train_mcfg = self._dp_loop.mcfg if self._dp_loop is not None else self.mcfg
        # the training kernels, or torch autograd for what they do not cover;
        # under PIN_SLAM_EXACT_KNN=1 the uncached loop, by autograd
        self.kernel_path = (not self.exact_knn
                            and mp.kernel_path_supported(self.train_mcfg, cfg))
        if self._dp_loop is not None:
            self._dp_loop.autograd = not self.kernel_path
        self.sync_stages = sync_stages
        self.rand = random_source or RandomSource(
            cfg.seed, dev, rank=self.dp_mesh.rank if self.dp_mesh is not None else None)

        self.offsets = torch.as_tensor(npts.neighbor_offsets(cfg.num_nei_cells,
                                                             cfg.search_alpha), device=dev)
        far_offsets = (torch.as_tensor(npts.neighbor_offsets(
            cfg.far_num_nei_cells, cfg.far_search_alpha), device=dev)
            if cfg.far_num_nei_cells > 0 else None)
        if self.mc.nsub > 1:
            self.append_tmpl = npts.make_probe_template(self.mc, cfg.num_nei_cells,
                                                        cfg.search_alpha, dev)
            self.far_tmpl = (npts.make_probe_template(
                self.mc, cfg.far_num_nei_cells, cfg.far_search_alpha, dev)
                if cfg.far_num_nei_cells > 0 else None)
        else:
            self.append_tmpl, self.far_tmpl = self.offsets, far_offsets

        gen = torch.Generator().manual_seed(int(cfg.seed))
        in_dim = cfg.feature_dim + self.mc.vec_dim      # features + (encoded) offset vector
        self.decoder = Decoder(in_dim, cfg.geo_mlp_hidden_dim,
                               cfg.geo_mlp_level, 1, cfg.mlp_bias_on, generator=gen,
                               device=dev)
        self.decoder.requires_grad_(False)
        self.sem_decoder = None
        if cfg.semantic_on:
            self.sem_decoder = Decoder(in_dim, cfg.sem_mlp_hidden_dim,
                                       cfg.sem_mlp_level, cfg.sem_class_count,
                                       cfg.mlp_bias_on, generator=gen, device=dev)
            self.sem_decoder.requires_grad_(False)
        self.color_decoder = None
        if cfg.color_on:
            self.color_decoder = Decoder(in_dim, cfg.color_mlp_hidden_dim,
                                         cfg.color_mlp_level, max(cfg.color_channel, 1),
                                         cfg.mlp_bias_on, generator=gen, device=dev)
            self.color_decoder.requires_grad_(False)

        wd = cfg.use_probe_dedup
        self._use_dedup = wd is True or wd == "true" or wd not in (False, "false")
        # dedup_group_probe packs frame-recentred voxel coordinates into 10
        # bits an axis: exact while a frame's probe extent, 2 * max_range /
        # voxel_size cells, stays under 1024 (KITTI 2 * 80 / 0.4 = 400,
        # Replica 2 * 10 / 0.05 = 400); past it the 30-bit group key would
        # alias voxels, so the per-item probe runs instead
        if self._use_dedup and int(np.ceil(2.0 * cfg.max_range / self.mc.voxel_size)) >= 1024:
            self._use_dedup = False

        self.state = (self._spatial.init_state() if self._spatial is not None
                      else npts.init_map_state(self.mc, dev))
        self.lm = npts.init_local_map(self.mc, dev)
        self.pool = mp.init_pool(self.mcfg, dev, color_channel=max(cfg.color_channel, 1))
        self.sdf_scale = cfg.sdf_scale
        self.cur_pose = np.eye(4)
        if self.dataset.gt_pose_provided and cfg.track_on:
            self.cur_pose = self.dataset.gt_poses[cfg.begin_frame].copy()
            self.dataset.last_pose = self.cur_pose.copy()
        self.lm_origin64 = np.zeros(3)
        self.frame_id = 0
        self.stage_times = []      # [upload, odometry, map update, training, pgo] a frame
        self.map_counts = []       # the map's count after each frame, device scalars
        self.mesh_colors = None    # the last whole-map mesh's vertex colours (colour head)
        self.mesh_sem_labels = None  # its vertex classes (semantic head)
        self.metrics = {}          # the trajectory's, set by run()
        self._travel = torch.zeros((TS_CAPACITY,), dtype=torch.float32, device=dev)
        self._stop_count = 0

        # back end: loop closure + pose graph
        self.after_pgo = False
        self.pgm = pgo_mod.PoseGraphManager(cfg) if cfg.pgo_on else None
        self.loop_mgr = (ld.NeuralPointMapContextManager(ld.LoopConfig.from_config(cfg))
                         if cfg.pgo_on and cfg.global_loop_on else None)
        self.gt_loop_mgr = (ld.GTLoopManager(cfg.max_loop_dist)
                            if cfg.pgo_on and cfg.use_gt_loop else None)
        self.tc_loop = trk.TrackerConfig.from_config(cfg, loop_reg=True)
        self.loop_reg_failed_count = 0
        self.last_source = None        # the frame's source cloud (and its normals), for
        #                                loop verification
        self.last_reg_cov = None

        # the in-run artifacts and the control channel (control.json)
        self._mesh_now = False         # a mesh + viewer refresh at the next frame
        self._pause_at_loop = False    # pause right after a loop closure is applied
        self._mc_overrides = {}        # live mc_res_m / mesh_min_nn of the in-run mesher
        self._vis_mesher = None
        self._sensor_glyph = None
        self._mesh_cache = (None, None, None)   # the last mesh (vertices, faces, colours)
        self._warned_keys = set()

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.sync_stages and self.device.type == "cuda":
            tracing.stage_sync(self.device)

    def _source_prep(self, points, valid, colors=None):
        """(source points, their validity): the frame's first point of each
        ``source_vox_down_m`` voxel; with ``colors`` (B, C), (points,
        validity, their colours)."""
        cfg = self.config
        keep = voxel_down_sample_mask(points, valid, cfg.source_vox_down_m,
                                      cfg.downsample_hash_size)
        idx = nonzero_static(keep, cfg.source_bucket, 0)
        n_keep = torch.sum(keep)
        src_valid = torch.arange(cfg.source_bucket, device=self.device) < n_keep
        if colors is None:
            return points[idx], src_valid
        return points[idx], src_valid, colors[idx]

    def _source_normals(self, src, src_valid):
        """(normals, their validity) of the source cloud with
        ``estimate_normal`` (a ``source_vox_down_m`` grid), else (None, None)."""
        if not self.config.estimate_normal:
            return None, None
        return estimate_normals(src, src_valid, max(self.config.source_vox_down_m, 1e-3))

    def dynamic_static_mask(self, points, pose_R, pose_t) -> torch.Tensor:
        """The dynamic filter's keep mask of a frame's points (B, 3) in the
        sensor frame at the pose (pose_R, pose_t): False where the current
        local map is certain (interpolated certainty at least
        ``dynamic_certainty_thre``) that the point lies in free space (its
        SDF at least ``dynamic_sdf_ratio_thre`` voxels)."""
        cfg, mc = self.config, self.mc
        pts_world = points @ pose_R.T + pose_t
        knn = npts.knn_search(self.lm, mc, pts_world, self.offsets)
        feat, w, cert = npts.interpolate_features(self.lm, mc, pts_world, knn.lidx)
        sdf_pred, _ = self.decoder.blended_sdf(feat, w, mc.weighted_first, cfg.sdf_scale)
        return ((cert < cfg.dynamic_certainty_thre)
                | (sdf_pred < cfg.dynamic_sdf_ratio_thre * cfg.voxel_size_m))

    def _frame_update(self, points, valid, pose_R, pose_t, frame_id, colors=None,
                      sem_labels=None):
        """(Dynamic filter ->) sample -> insert -> local map -> new flags ->
        kNN probe -> pool append (with ``colors`` (B, C) / ``sem_labels``
        (B,), the samples' colour labels / classes too), each in its part
        of the ``map_update`` span."""
        cfg, mc, mcfg, sc = self.config, self.mc, self.mcfg, self.sc
        dev = self.device
        part = tracing.part
        with part("sample"):
            if not cfg.rand_downsample:
                valid = valid & voxel_down_sample_mask(points, valid, cfg.vox_down_m,
                                                       cfg.downsample_hash_size)
            if cfg.dynamic_filter_on:
                valid = valid & self.dynamic_static_mask(points, pose_R, pose_t)
            if cfg.mapping_bucket and cfg.mapping_bucket < points.shape[0]:
                Mb = cfg.mapping_bucket
                cidx = nonzero_static(valid, Mb, points.shape[0])
                n_val = torch.sum(valid)
                points = torch.cat([points, torch.zeros((1, 3), device=dev)])[cidx]
                valid = torch.arange(Mb, device=dev) < torch.clamp(n_val, max=Mb)
                if colors is not None:
                    colors = torch.cat([colors, colors.new_zeros((1, colors.shape[1]))])[cidx]
                if sem_labels is not None:
                    sem_labels = torch.cat([sem_labels, sem_labels.new_zeros((1,))])[cidx]
            batch = sample_rays(sc, points, valid,
                                self.rand.ray_noise(frame_id, sc, points.shape[0]),
                                colors, sem_labels)
            coord_world = batch.coord @ pose_R.T + pose_t
            Sn, n_surf_tot = sc.ray_sample_count, 1 + sc.surface_sample_n
            cw_surf = coord_world.reshape(-1, Sn, 3)[:, :n_surf_tot].reshape(-1, 3)
            lbl_surf = batch.sdf_label.reshape(-1, Sn)[:, :n_surf_tot].reshape(-1)
            vld_surf = batch.valid.reshape(-1, Sn)[:, :n_surf_tot].reshape(-1)
            surf_mask = vld_surf & (torch.abs(lbl_surf)
                                    < cfg.surface_sample_range_m * cfg.map_surface_ratio)
        if self._spatial is None:
            with part("insert"):
                self.state = npts.map_insert(
                    self.state, mc, cw_surf, surf_mask, frame_id, self._travel,
                    downsample_table_size=cfg.downsample_hash_size,
                    insert_bucket=min(cfg.frame_bucket, cw_surf.shape[0]))
            with part("local_map"):
                lm = npts.build_local_map(self.state, mc, pose_t, frame_id, self._travel)
        else:
            with part("insert"):
                self.state = self._spatial.insert(self.state, cw_surf, surf_mask, frame_id,
                                                  self._travel)
            with part("local_map"):
                self._slms, lm = self._spatial.extract(self.state, pose_t, frame_id,
                                                       self._travel)

        with part("new_mask"):
            new_full = mp.compute_new_sample_mask(lm, mc, mcfg, coord_world, batch.sdf_label,
                                                  batch.valid)
            col = torch.arange(Sn, device=dev) < n_surf_tot
            new_mask = (new_full.reshape(-1, Sn) & col[None, :]).reshape(-1)
        with part("append_knn"):
            n_rays_f = coord_world.shape[0] // Sn
            n_far = n_rays_f * (Sn - 1 - sc.surface_sample_n)
            gidx, w, vec, nvec, dropped = mp.append_knn(
                lm, mc, self.append_tmpl, coord_world, Sn, near_count=n_surf_tot,
                far_offsets=self.far_tmpl, per_neighbor_vecs=not mcfg.weighted_first,
                dedup_far_budget=int(n_far * cfg.probe_dedup_budget) if self._use_dedup else 0,
                quats=self._quats(lm) if self.after_pgo else None,
                pos_encode=mc.pos_encode)
        with part("pool_append"):
            self.pool = mp.pool_append(self.pool, mcfg, coord_world, batch.coord,
                                       batch.sdf_label, batch.weight, batch.valid & ~dropped,
                                       frame_id, new_mask, gidx, w, vec, nvec,
                                       color_label=batch.color_label,
                                       sem_label=batch.sem_label)
        return lm

    def _quats(self, lm) -> torch.Tensor:
        """The global quaternion rows (cap + 1, 4) the post-PGO kNN probe
        reads; under map sharding those of the merged window's members (the
        only rows its probe can return), the rest the sentinel's."""
        if self._spatial is None:
            return self.state.attr_rows[:, npts.C_QUAT]
        q = npts.attr_sentinel_row(self.device)[npts.C_QUAT].expand(
            self.mc.capacity + 1, 4).clone()
        q[lm.indices] = lm.attr_rows[:, npts.C_QUAT]
        return q

    def _write_back(self, lm) -> None:
        """The trained local window back into the global map (into every
        shard's own rows under map sharding)."""
        with tracing.part("write_back"):
            if self._spatial is None:
                self.state = npts.assign_local_to_global(self.state, lm, self.mc, self._travel)
            else:
                self.state = self._spatial.writeback(self.state, self._slms, lm.attr_rows,
                                                     lm.geo_features, lm.color_features,
                                                     self._travel)

    def _map_count(self) -> int:
        """The global map's points (every shard's under map sharding)."""
        if self._spatial is not None and not self._dense:
            return self._spatial.map_count(self.state)
        return int(self.state.count)

    def _decoder_leaves(self):
        """The decoders as a training call takes them: the packed vector on
        the kernel path, else a ``mapper.Heads`` (the SDF decoder and the
        semantic decoder)."""
        if self.kernel_path:
            return self.decoder.pack()
        return mp.init_heads(self.decoder, self.sem_decoder)

    def _load_decoders(self, params) -> None:
        if self.kernel_path:
            self.decoder.load_packed(params)
        else:
            params.load_into(self.decoder, self.sem_decoder)

    def _train(self, lm, feats, gvec, opt, frame_id, chunk, use_new, dec_scale, num_iters,
               color=None):
        """``num_iters`` Adam iterations on ``lm``, on the kernel path or by
        autograd; returns (lm_out, feats, decoder leaves, opt, loss history)
        with lm_out's features (and, with the colour state ``color``, its
        colour features) set to the trained ones."""
        with tracing.part("batch"):
            idx = self.rand.batch_indices(frame_id, chunk, self.pool, self.train_mcfg,
                                          use_new, num_iters)
        with tracing.part("loop"):
            if self._dp_loop is not None:
                lm2, feats, gvec, opt, hist = self._dp_loop(
                    lm, self.mc, feats, gvec, opt, self.pool, idx, dec_scale, self.after_pgo,
                    color=color)
            elif self.exact_knn:
                # the JAX package's run_exact: the certainty column stripped (the
                # loop folds the certainty itself), fresh Adam moments on the slim
                # leaves every call, the zero column put back; ``opt`` passes through
                F, L = self.mc.feature_dim, self.mc.local_capacity
                slim = feats[:, :F].contiguous()
                if color is not None:
                    color.opt = mp.init_color_state(color.features, color.decoder).opt
                lm2, slim, gvec, _, hist = mp.mapping_loop(
                    lm, self.mc, slim, gvec, mp.init_opt_state(slim, gvec), self.pool, self.mcfg,
                    self.offsets, idx, dec_scale, self.after_pgo, color=color)
                feats = torch.cat([slim, slim.new_zeros((L + 1, 1))], 1)
            elif self.kernel_path:
                lm2, feats, gvec, opt, hist = mp.mapping_loop_cached(
                    lm, self.mc, feats, gvec, opt, self.pool, self.mcfg, idx, dec_scale,
                    self.after_pgo, color=color)
            else:
                lm2, feats, gvec, opt, hist = mp.mapping_loop_autograd(
                    lm, self.mc, feats, gvec, opt, self.pool, self.mcfg, idx, dec_scale,
                    self.after_pgo, color=color)
        lm2.geo_features = feats[:, :self.mc.feature_dim]
        if color is not None:
            lm2.color_features = color.features
        return lm2, feats, gvec, opt, hist

    def _color_state(self, lm):
        """Fresh colour leaves of a frame's training (None without colour)."""
        if self.color_decoder is None:
            return None
        return mp.init_color_state(lm.color_features, self.color_decoder)

    def _with_cert_column(self, lm):
        L = self.mc.local_capacity
        return torch.cat([lm.geo_features, torch.zeros((L + 1, 1), device=self.device)], 1)

    def _travel_step(self, frame_id: int, tran_sel: float) -> None:
        travel_now = self._travel[max(frame_id - 1, 0)] + tran_sel
        self._travel[frame_id] = travel_now

    # ------------------------------------------------------------------
    def process_frame(self, frame: Frame) -> dict:
        """One frame through the stages; returns its info dict, with
        ``info["trace"]`` the frame's report (``utils/tracing.py``: the
        spans' host milliseconds, the counted host syncs and their waits,
        the event counts, the kernel launches).  ``stage_times`` gets the
        frame's row of the five stage spans, in seconds."""
        cfg, dev = self.config, self.device
        info = {}
        with tracing.frame(self.frame_id) as report:
            info["trace"] = report
            self._poll_control()
            with torch.no_grad():
                kept = self._frame_stages(frame, info)
            self.stage_times.append([report["span_ms"].get(f"pin_slam.{s}", 0.0) * 1e-3
                                     for s in STAGE_SPANS])
            self.dataset.time_table.append(self.stage_times[-1])
            if not kept:
                self.frame_id += 1
                info["skipped"] = True
                return info
            st = self.stage_times[-1]
            wandb_log.log({"timing(s)/preprocess": st[0], "timing(s)/tracking": st[1],
                           "timing(s)/mapping": st[2] + st[3], "timing(s)/pgo": st[4],
                           **({"loss/loss_last": info["loss_last"]} if "loss_last" in info
                              else {})},
                          step=self.frame_id)
            if cfg.o3d_vis_on or self._mesh_now:
                # mesh_now (control.json) overrides the gate: an explicit request
                # for a mesh and a viewer refresh mid-run
                self._periodic_artifacts(info)
            # kept on the device (no host sync a frame); read once at save time
            self.map_counts.append(self.state.count)
            self.frame_id += 1
        return info

    def _frame_stages(self, frame: Frame, info: dict) -> bool:
        """The frame's stages, each in its span: upload, odometry (with a
        conservative frame's pose-book settling), the back end's work before
        the map update (pgo: descriptor, or loop closure and BA), map update,
        training, and after it the deferred pose booking (odometry) and the
        pose graph's bookkeeping (pgo).  Returns False for a frame skipped
        after tracking was lost."""
        cfg, dev = self.config, self.device
        span = tracing.span
        with span("pin_slam.upload"):
            points = tracing.upload(frame.points, "points", dev, torch.float32)
            valid = tracing.upload(frame.valid, "valid", dev)
            colors = (tracing.upload(frame.colors, "colors", dev, torch.float32)
                      if cfg.color_on and frame.colors is not None else None)
            sem = (tracing.upload(frame.sem_labels, "sem_labels", dev, torch.int32)
                   if cfg.semantic_on and frame.sem_labels is not None else None)
        tracked = cfg.track_on and self.frame_id > 0
        # detection frames settle the pose books (and a loop closure may
        # replace the pose) before the map update
        detect_due = (self.pgm is not None and self.frame_id > 0
                      and self.frame_id % max(cfg.pgo_freq, 1) == 0)
        ba_due = (cfg.ba_freq_frame > 0 and self.frame_id > cfg.ba_frame // 2
                  and (self.frame_id + 1) % cfg.ba_freq_frame == 0)
        conservative = (not tracked or detect_due or ba_due
                        or (self.frame_id > 0 and self.dataset.stop_status))

        booked = None
        with span("pin_slam.odometry"):
            if tracked:
                init_pose = self.dataset.initial_guess()
                origin64 = self.lm_origin64
                R_init = torch.as_tensor(init_pose[:3, :3], dtype=torch.float32)
                t_init = torch.as_tensor(init_pose[:3, 3] - origin64, dtype=torch.float32)
                with span("pin_slam.odometry.source_prep"):
                    src, src_valid, *src_col = self._source_prep(points, valid, colors)
                with span("pin_slam.odometry.normals"):
                    nrm, nrm_valid = self._source_normals(src, src_valid)
                self.last_source = (src, src_valid, nrm, nrm_valid)
                # the map's origin on the host: the tracker's kernel takes it by
                # value, and pose selection adds it back
                origin = tracing.read(self.lm.origin, "origin")
                res = trk.track_frame(self.lm, self.mc, self.tc, self.decoder, self.sdf_scale,
                                      self.append_tmpl, src, src_valid, R_init, t_init,
                                      after_pgo=self.after_pgo,
                                      color_decoder=self.color_decoder,
                                      source_colors=src_col[0] if src_col else None,
                                      source_normals=nrm,
                                      source_normal_valid=nrm_valid, origin=origin)
                with span("pin_slam.odometry.pose_select"):
                    # pose selection in float32, as the JAX package does on device
                    t_last_w = torch.as_tensor(self.cur_pose[:3, 3], dtype=torch.float32)
                    t_est_w = res.t + origin
                    jump = bool(torch.linalg.norm(t_est_w - t_last_w)
                                > 40.0 * cfg.surface_sample_range_m)
                    ok = res.valid and not jump
                    R_sel = res.R if ok else R_init
                    t_w = t_est_w if ok else t_init + origin
                    tran_sel = float(torch.linalg.norm(t_w - t_last_w))

                def fetch_and_book():
                    if res.valid:
                        T = np.eye(4)
                        T[:3, :3] = res.R.double().numpy()
                        T[:3, 3] = res.t.double().numpy() + origin64
                        self.cur_pose = T
                    else:
                        self.cur_pose = init_pose
                    self.dataset.update_odom_pose(self.cur_pose, res.valid)
                    self.last_reg_cov = res.cov.double().numpy()
                    info["reg_valid"] = res.valid
                    info["reg_residual_cm"] = res.sdf_residual_cm
                    info["reg_iters"] = res.iterations
                    if self.tc.photometric_on and self.color_decoder is not None:
                        info["photo_count"] = res.photo_count
                booked = fetch_and_book
                if conservative:
                    booked()
                    booked = None
            else:
                if not cfg.track_on and self.dataset.gt_pose_provided:
                    self.cur_pose = self.dataset.gt_poses[self.frame_id].copy()
                self.dataset.update_odom_pose(self.cur_pose, True)
                self.last_reg_cov = None
                ok = True
            self._sync()

        if self.loop_mgr is not None and tracked and not conservative:
            # descriptor of the PRE-update local map at the selected pose
            with span("pin_slam.pgo"):
                with span("pin_slam.pgo.descriptor"):
                    feats = self.lm.geo_features if cfg.loop_with_feature else None
                    self.loop_mgr.add_node_device(self.frame_id, self.lm.positions,
                                                  self.lm.count, R_sel, t_w, feats)
                self._sync()

        if conservative:
            if self.pgm is not None and not self.dataset.lose_track:
                with span("pin_slam.pgo"):
                    self._loop_closure_stage(info)
                    self._sync()
            if self.dataset.lose_track:
                return False
            if ba_due:
                # bundle adjustment's time is the back end's (the pgo column)
                with span("pin_slam.pgo"):
                    info["ba"] = self._bundle_adjustment()
                    self._sync()
            with span("pin_slam.odometry"), span("pin_slam.odometry.pose_select"):
                R_sel = torch.as_tensor(self.cur_pose[:3, :3], dtype=torch.float32)
                t_w = torch.as_tensor(self.cur_pose[:3, 3], dtype=torch.float32)
                ok = True
                td = self.dataset.travel_dist
                tran_sel = float(np.float32(td[-1] - td[-2])) if len(td) > 1 else 0.0

        fid = self.frame_id
        dec_scale = 0.0 if fid >= cfg.freeze_after_frame else 1.0
        stop_frame = fid > 0 and self.dataset.stop_status
        with span("pin_slam.map_update"):
            R_d = tracing.upload(R_sel, "pose_R", dev)
            t_d = tracing.upload(t_w, "pose_t", dev)
            self._travel_step(fid, tran_sel)
            gvec = self._decoder_leaves()
            if not stop_frame:
                self._stop_count = (self._stop_count + 1
                                    if tran_sel < 0.01 * cfg.voxel_size_m else 0)
                use_new = ok and not (self._stop_count > cfg.stop_frame_thre)
                lm2 = self._frame_update(points, valid & ok, R_d, t_d, fid, colors, sem)
                self._sync()

        with span("pin_slam.training"):
            if stop_frame:
                # a stop frame trains the existing local map, with no update
                n_it = max(1, cfg.iters - 10) if cfg.adaptive_mode else int(cfg.iters)
                feats = self._with_cert_column(self.lm)
                opt = mp.init_opt_state(feats, gvec)
                color = self._color_state(self.lm)
                lm_out, feats, gvec, opt, hist = self._train(
                    self.lm, feats, gvec, opt, fid, -2, False, dec_scale, n_it, color)
            else:
                feats = self._with_cert_column(lm2)
                opt = mp.init_opt_state(feats, gvec)
                color = self._color_state(lm2)
                if ok:
                    lm_out, feats, gvec, opt, hist = self._train(
                        lm2, feats, gvec, opt, fid, -1, use_new, dec_scale, int(cfg.iters),
                        color)
                else:
                    # lost frame: keep the rebuilt local map and the untrained
                    # parameters (the JAX package trains and then discards)
                    lm_out, hist = lm2, None
            self._write_back(lm_out)
            self.lm = lm_out
            self._load_decoders(gvec)
            if color is not None and hist is not None:
                color.load_into(self.color_decoder)

        if booked is not None:
            # the tracker's result reaches the pose books while the card trains
            with span("pin_slam.odometry"):
                booked()
            if self.pgm is not None:
                with span("pin_slam.pgo"), span("pin_slam.pgo.bookkeeping"):
                    if self.dataset.lose_track:
                        if self.loop_mgr is not None:
                            self.loop_mgr.drop_pending(fid)
                    else:
                        self._pgo_bookkeeping(fid)

        with span("pin_slam.training"):
            self.lm_origin64 = self.cur_pose[:3, 3].copy()
            if (fid + 1) % cfg.pool_filter_freq == 0:
                self.pool = mp.pool_filter(self.pool, self.mcfg, t_d)
            extra_chunks = cfg.init_iter_ratio - 1 if fid == 0 else 0
            for chunk in range(extra_chunks):
                self.lm, feats, gvec, opt, hist = self._train(
                    self.lm, feats, gvec, opt, fid, chunk, True, dec_scale, int(cfg.iters),
                    color)
                self._write_back(self.lm)
                self._load_decoders(gvec)
                if color is not None:
                    color.load_into(self.color_decoder)
            if cfg.log_loss_per_frame and hist is not None:
                info["loss_last"] = tracing.read(hist[-1], "loss_last", float)
                info["loss_finite"] = tracing.read(torch.isfinite(hist).all(), "loss_finite",
                                                   bool)
            self._sync()
        return True

    # ------------------------------------------------------------------
    def _run_path(self) -> str:
        cfg = self.config
        return cfg.run_path or os.path.join(cfg.output_root, cfg.name or "run")

    def _periodic_artifacts(self, info: dict) -> None:
        """In-run artifacts under ``<run>/vis`` (the reference's visualizer
        refreshes, pin_slam.py:272-341): a mesh of the local map every
        ``mesh_freq_frame`` frames, right after a loop closure's map
        deformation and on ``mesh_now``, with the live ``viewer.html`` /
        ``viewer_data.js`` refreshed beside it (trajectory, sensor glyph at
        the current pose, the local map's points, a strided sample of at
        most 40 k pool rows, the status line); an SDF slice at
        ``sdf_slice_height`` above the sensor every ``sdfslice_freq_frame``
        frames.  Runs after the frame's stage times are taken; the
        milliseconds of each part go into ``info["vis_ms"]``.  A failed
        viewer export warns once and never stops the run.  With several
        ranks every rank computes the same artifacts (the mesher's queries
        are split over them) and rank 0 alone writes them."""
        cfg = self.config
        fid = self.frame_id
        run_path = self._run_path()
        vis_dir = os.path.join(run_path, "vis")
        write = self.is_writer
        if write:
            os.makedirs(vis_dir, exist_ok=True)
        if self._vis_mesher is None:
            over = self._mc_overrides
            self._vis_mesher = Mesher(MesherConfig(
                mc_res_m=float(over.get("mc_res_m", cfg.mc_res_m)),
                mesh_min_nn=int(over.get("mesh_min_nn", cfg.mesh_min_nn)),
                min_cluster_vertices=cfg.min_cluster_vertices,
                query_bucket=cfg.mesh_query_bucket), self.mc, self.offsets,
                dp_mesh=self.dp_mesh)

        mesh_due = ((fid > 0 and cfg.mesh_freq_frame > 0 and fid % cfg.mesh_freq_frame == 0)
                    or info.get("pgo_applied") or self._mesh_now)
        slice_due = cfg.sdfslice_freq_frame > 0 and fid % cfg.sdfslice_freq_frame == 0
        self._mesh_now = False
        if not (mesh_due or slice_due):
            return
        count = tracing.read(self.lm.count, "local_count", int)
        if count == 0:
            return
        ms = info.setdefault("vis_ms", {})
        origin = self.cur_pose[:3, 3]
        if mesh_due:
            with tracing.span("pin_slam.vis.mesh") as sp:
                pts = tracing.read(self.lm.positions[:count], "mesh_points").numpy()
                rad = cfg.max_range
                amin = np.maximum(pts.min(axis=0), origin - rad) - 0.5
                amax = np.minimum(pts.max(axis=0), origin + rad) + 0.5
                out = self._vis_mesher.recon_aabb_mesh(
                    self.lm, self.decoder, self.sdf_scale, amin, amax,
                    color_decoder=self.color_decoder, sem_decoder=self.sem_decoder)
                v, f = out[:2]
                c = out[2] if len(out) == 4 else None
                if v.shape[0]:
                    if write:
                        pio.write_ply(os.path.join(vis_dir, f"mesh_{fid:05d}.ply"), v,
                                      colors=c, normals=vertex_normals(v, f), faces=f)
                    self._mesh_cache = (v, f, c)
            ms["mesh"] = sp.ms
            map_points = self._map_count()
            with tracing.span("pin_slam.vis.viewer") as sp:
                if write:
                    try:
                        self._export_live_viewer(run_path, fid, pts, v, f, c, map_points)
                    except Exception as e:
                        self._warn_once("viewer", f"live viewer export failed: {e!r}")
            ms["viewer"] = sp.ms
        if slice_due:
            with tracing.span("pin_slam.vis.sdf_slice") as sp:
                height = origin[2] + cfg.sdf_slice_height
                pts_sl, sdf_sl = self._vis_mesher.sdf_slice(self.lm, self.decoder,
                                                            self.sdf_scale, origin,
                                                            cfg.max_range, height)
                if pts_sl.shape[0] and write:
                    pio.write_ply(os.path.join(vis_dir, f"sdf_slice_{fid:05d}.ply"), pts_sl,
                                  extra={"sdf": sdf_sl})
            ms["sdf_slice"] = sp.ms

    def _export_live_viewer(self, run_path, fid, pts, v, f, c, map_points: int) -> None:
        """The live viewer's refresh: one narrow copy of a strided pool
        sample (world coordinates, label, frame id) to the host."""
        cfg = self.config
        poses = self.dataset.pgo_poses if cfg.pgo_on else self.dataset.odom_poses
        traj = (np.stack([p[:3, 3] for p in poses]).astype(np.float32) if len(poses)
                else None)
        n_loops = (len([e for e in self.pgm.edges if abs(e.j - e.i) > 1])
                   if self.pgm is not None else 0)
        if self._sensor_glyph is None:
            name = os.path.splitext(os.path.basename(cfg.sensor_cad_path or ""))[0] or "lidar"
            self._sensor_glyph = sensor_cad.glyph(name)
        gv, gf = self._sensor_glyph
        gv_w = (gv @ self.cur_pose[:3, :3].T + self.cur_pose[:3, 3]).astype(np.float32)
        stride = max(1, int(self.pool.rows.shape[0]) // 40000)
        pool_rows = self.pool.rows[::stride, :6].cpu().numpy()
        pool_ok = pool_rows[:, mp.P_TS] >= 0.0
        export_html(os.path.join(run_path, "viewer.html"), neural_points=pts,
                    mesh_verts=v if v.shape[0] else None,
                    mesh_faces=f if v.shape[0] else None, mesh_colors=c, trajectory=traj,
                    sensor_verts=gv_w, sensor_faces=gf,
                    pool_points=pool_rows[pool_ok][:, mp.P_COORD],
                    pool_labels=pool_rows[pool_ok][:, mp.P_LABEL], live=True,
                    meta={"frame": fid, "rev": fid, "map_points": map_points,
                          "loops": n_loops, "paused": False,
                          "sensor": [float(x) for x in self.cur_pose[:3, 3]]})

    # ------------------------------------------------------------------
    # the control channel: <run>/control.json, written by hand, by
    # utils/viewer_server.py (POST /control) or by the pause-at-loop hook
    def _control_path(self) -> str:
        return os.path.join(self._run_path(), "control.json")

    def _read_control(self) -> dict:
        try:
            with open(self._control_path()) as f:
                return json.load(f) or {}
        except (OSError, ValueError):
            return {}

    def _write_control(self, state: dict) -> None:
        path = self._control_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)

    def _poll_control(self) -> None:
        """Read ``control.json`` before a frame (the reference visualizer's
        pause / step keys, utils/visualizer.py:211-242, 344-346): ``mesh_now``
        (consumed), ``pause_at_loop`` (latched for the loop-closure hook),
        ``mc_res_m`` / ``mesh_min_nn`` (the in-run mesher is rebuilt with
        them when they change), and ``pause``, which holds the run until it
        is cleared or ``step`` lets frames through one at a time.  With
        several ranks rank 0 reads the file and hands its decisions to the
        others (one broadcast a frame), which wait for it while it pauses."""
        if self.is_writer:
            ctl = self._read_control()
            decided = self._hold_control(ctl) if ctl else None
        else:
            decided = None
        if self._ranks is not None:
            from pin_slam_torch.parallel import mesh as pmesh

            decided = pmesh.broadcast_object(self._ranks, decided,
                                             src=self._ranks.ranks.index(0))
        if decided is None:
            return
        mesh_now, self._pause_at_loop, mc_over = decided
        self._mesh_now = self._mesh_now or mesh_now
        if mc_over and mc_over != self._mc_overrides:
            self._mc_overrides = mc_over
            self._vis_mesher = None          # rebuilt with the new parameters
            if self.is_writer:
                print(f"[pipeline] live mesher retune: {mc_over}", flush=True)

    def _hold_control(self, ctl: dict):
        """Consume ``mesh_now``, hold the run while ``pause`` is set (``step``
        lets frames through one at a time); returns (mesh now, pause at the
        next loop closure, the in-run mesher's overrides)."""
        mesh_now = bool(ctl.pop("mesh_now", False))
        if mesh_now:
            self._write_control(ctl)
        decided = (mesh_now, bool(ctl.get("pause_at_loop", False)),
                   {k: ctl[k] for k in ("mc_res_m", "mesh_min_nn") if k in ctl})
        waited = False
        while ctl.get("pause"):
            if int(ctl.get("step", 0) or 0) > 0:
                ctl["step"] = int(ctl["step"]) - 1
                self._write_control(ctl)     # one stepped frame consumed
                break
            if not waited:
                print(f"[pipeline] paused at frame {self.frame_id} "
                      f"(control.json; set pause=false or step=N)", flush=True)
                self._refresh_viewer_meta(paused=True)
                waited = True
            time.sleep(0.25)
            ctl = self._read_control()
        if waited:
            self._refresh_viewer_meta(paused=False)
        return decided

    def _refresh_viewer_meta(self, paused: bool) -> None:
        """Rewrite only the live viewer's status line (``paused``, and a new
        ``rev`` so an open page redraws), keeping the layers."""
        sidecar = os.path.join(os.path.dirname(self._control_path()), "viewer_data.js")
        if not os.path.exists(sidecar):
            return
        try:
            with open(sidecar) as f:
                txt = f.read()
            m = re.search(r"(.*window\.__PIN_DATA\(.*, )(\{[^{}]*\})(\);)\s*$", txt, re.S)
            if not m:
                return
            meta = json.loads(m.group(2))
            meta["paused"] = paused
            meta["rev"] = str(meta.get("rev", "")) + ("p" if paused else "r")
            with open(sidecar + ".tmp", "w") as f:
                f.write(m.group(1) + json.dumps(meta) + m.group(3))
            os.replace(sidecar + ".tmp", sidecar)
        except Exception as e:
            self._warn_once("viewer_meta", f"viewer meta refresh failed: {e!r}")

    def _warn_once(self, key: str, msg: str) -> None:
        """Print a warning at most once a run per key, where an optional
        artifact catches broadly so that it never stops a run."""
        if key not in self._warned_keys:
            self._warned_keys.add(key)
            print(f"[pipeline] WARNING: {msg}", flush=True)

    # ------------------------------------------------------------------
    def _pgo_bookkeeping(self, fid: int) -> None:
        """One pose-graph node and one odometry factor from the pose books."""
        pgm = self.pgm
        cur = self.dataset.pgo_poses[fid].copy()
        pgm.add_frame_node(fid, cur)
        if fid > 0:
            rel = np_se3_inverse(self.dataset.pgo_poses[fid - 1]) @ cur
            cov = self.last_reg_cov if self.config.use_reg_cov_mat else None
            pgm.add_odometry_factor(fid, fid - 1, rel, cov)
        if self.gt_loop_mgr is not None and self.dataset.gt_pose_provided:
            self.gt_loop_mgr.add_node(fid, self.dataset.gt_poses[fid])

    def _f32_dev(self, a, site: str) -> torch.Tensor:
        """``a`` as float32 on the device: a counted upload at ``site``."""
        return tracing.upload(np.asarray(a, np.float32), site, self.device)

    def _loop_closure_stage(self, info: dict) -> None:
        """The pose-graph stage of a conservative frame: bookkeeping and the
        frame's descriptor, and on detection frames loop detection,
        verification, optimisation and map deformation, each in its span."""
        cfg, mc = self.config, self.mc
        fid = self.frame_id
        pgm = self.pgm
        travel = self.dataset.travel_dist
        cur = self.dataset.pgo_poses[fid].copy()
        span = tracing.span

        with span("pin_slam.pgo.bookkeeping"):
            self._pgo_bookkeeping(fid)
            drift = pgm.estimate_drift(travel, fid)
        if self.loop_mgr is not None and fid > 0:
            with span("pin_slam.pgo.descriptor"):
                feats = self.lm.geo_features if cfg.loop_with_feature else None
                self.loop_mgr.add_node_device(fid, self.lm.positions, self.lm.count,
                                              self._f32_dev(cur[:3, :3], "pose_R"),
                                              self._f32_dev(cur[:3, 3], "pose_t"), feats)
        if fid == 0 or fid % max(cfg.pgo_freq, 1) != 0 or self.last_source is None:
            return

        with span("pin_slam.pgo.detect"):
            if self.loop_mgr is not None:
                self.loop_mgr.materialize_pending()
            # local loop first (pose distance within the drift radius), then the
            # global scan-context search; repeated verification failures tighten
            # the local acceptance distance (capped)
            poses = np.stack(self.dataset.pgo_poses)
            gt_trans = None
            yaw = 0.0
            if self.gt_loop_mgr is not None:
                loop_id, _, gt_trans = self.gt_loop_mgr.detect_loop()
            else:
                penalty = 1.0 + 0.3 * min(self.loop_reg_failed_count, 4)
                loop_id, _ = ld.detect_local_loop(
                    poses, travel, fid, drift, cfg.min_loop_travel_dist_ratio,
                    cfg.local_map_radius, cfg.max_loop_dist,
                    accept_divisor=penalty)
                if loop_id < 0 and self.loop_mgr is not None:
                    loop_id, _, yaw = self.loop_mgr.detect_global_loop(drift, travel, fid,
                                                                       poses=poses)
            if loop_id < 0:
                return
            if cfg.loop_z_check_on:
                # delta-z sanity check against multi-floor ambiguity
                rel_guess = np_se3_inverse(poses[loop_id]) @ (
                    poses[loop_id] @ gt_trans if gt_trans is not None else cur)
                if abs(rel_guess[2, 3]) > cfg.voxel_size_m * 4.0:
                    info["loop_z_rejected"] = True
                    return
            info["loop_candidate"] = loop_id

        with span("pin_slam.pgo.verify"):
            # verification: register this frame's source cloud against the map
            # around the loop pose, rebuilt with the travel window tightened to
            # half the travel gap (the map roughly as it was at the loop frame)
            loop_pose = poses[loop_id]
            if gt_trans is not None:
                guess = loop_pose @ gt_trans
            else:
                cz, sz = np.cos(yaw), np.sin(yaw)
                guess = loop_pose.copy()
                guess[:3, :3] = loop_pose[:3, :3] @ np.asarray([[cz, -sz, 0], [sz, cz, 0],
                                                                [0, 0, 1.0]])
            origin_loop = loop_pose[:3, 3].copy()
            tw = np.float32(min(mc.travel_dist_window,
                                max(0.5 * (travel[fid] - travel[loop_id]), 1e-3)))
            origin_d = self._f32_dev(origin_loop, "loop_origin")
            if self._spatial is None:
                lm_loop = npts.build_local_map(self.state, mc, origin_d, loop_id,
                                               self._travel, travel_window=float(tw))
            else:
                _, lm_loop = self._spatial.extract(self.state, origin_d, loop_id,
                                                   self._travel, travel_window=float(tw))
            source, src_valid, nrm, nrm_valid = self.last_source
            res = trk.track_frame(
                lm_loop, mc, self.tc_loop, self.decoder, self.sdf_scale, self.append_tmpl,
                source, src_valid, torch.as_tensor(guess[:3, :3].astype(np.float32)),
                torch.as_tensor((guess[:3, 3] - origin_loop).astype(np.float32)),
                after_pgo=self.after_pgo, source_normals=nrm, source_normal_valid=nrm_valid,
                origin=torch.as_tensor(np.asarray(origin_loop, np.float32)))
            if not res.valid:
                self.loop_reg_failed_count += 1
                info["loop_verified"] = False
                return
            info["loop_verified"] = True

        with span("pin_slam.pgo.optimize"):
            T_cur = np.eye(4)
            T_cur[:3, :3] = res.R.double().numpy()
            T_cur[:3, 3] = res.t.double().numpy() + origin_loop
            cov = res.cov.double().numpy() if cfg.use_reg_cov_mat else None
            pgm.add_loop_factor(fid, loop_id, np_se3_inverse(loop_pose) @ T_cur, cov)
            pgm.last_loop_idx = fid
            new_poses = pgm.optimize_pose_graph()
            pose_diff = pgm.get_pose_diff(poses)
            diff_full = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
            diff_full[:pose_diff.shape[0]] = pose_diff.astype(np.float32)
            poses_full = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
            poses_full[:new_poses.shape[0]] = new_poses.astype(np.float32)

        with span("pin_slam.pgo.deform"):
            # deform the map, then re-derive the pool from the new poses and
            # the moved points in one pass (neither adjust_map nor
            # recreate_hash reads the pool)
            if self._spatial is None:
                with span("pin_slam.pgo.deform.adjust_map"):
                    self.state = npts.adjust_map(self.state, mc,
                                                 self._f32_dev(diff_full, "pose_diff"))
                with span("pin_slam.pgo.deform.recreate_hash"):
                    self.state = npts.recreate_hash(
                        self.state, mc, fid, downsample_table_size=cfg.downsample_hash_size)
                attr_rows = self.state.attr_rows
            else:
                # per shard (each point moves by its own timestamp's correction);
                # the pool's cached neighbours read every shard's rows, gathered
                # into the shard-block id layout
                with span("pin_slam.pgo.deform.adjust_map"):
                    self.state = self._spatial.adjust(self.state,
                                                      self._f32_dev(diff_full, "pose_diff"))
                with span("pin_slam.pgo.deform.recreate_hash"):
                    self.state = self._spatial.recreate(self.state, fid)
                    attr_rows = self._spatial.gather_attr_rows(self.state)
            poses_d = self._f32_dev(poses_full, "poses")
            with span("pin_slam.pgo.deform.pool"):
                self.pool = pool_kernel.pool_pass(self.pool, poses_d, attr_rows, mc,
                                                  mc.pos_encode)
                self._sync()

        with span("pin_slam.pgo.local_map"):
            self.dataset.update_poses_after_pgo(new_poses)
            self.cur_pose = new_poses[fid].copy()
            origin = self._f32_dev(self.cur_pose[:3, 3], "origin")
            if self._spatial is None:
                self.lm = npts.build_local_map(self.state, mc, origin, fid, self._travel)
            else:
                self._slms, self.lm = self._spatial.extract(self.state, origin, fid,
                                                            self._travel)
            self.lm_origin64 = self.cur_pose[:3, 3].copy()
        self.after_pgo = True
        self.loop_reg_failed_count = 0
        info["pgo_applied"] = True
        # pause-at-loop (ref utils/visualizer.py:344-346): hold the run right
        # after the closure so that the deformed map can be inspected
        if self._pause_at_loop and self.is_writer:
            ctl = self._read_control()
            ctl["pause"] = True
            self._write_control(ctl)
            print(f"[pipeline] loop closure applied at frame {fid}; pausing "
                  f"(control.json pause_at_loop)", flush=True)

    def _bundle_adjustment(self) -> Optional[dict]:
        """Refine the last ``ba_frame`` poses (frame 0 stays fixed) and the
        local features jointly (``mapper.bundle_adjustment_loop``, 4 x
        ``iters`` iterations), write the poses back, then re-derive the
        pool's coordinates and cached kNN geometry (the map points do not
        move).  Returns the call's window, losses, mean pose shift and
        milliseconds (its span's), or None for a window under two poses."""
        with tracing.span("pin_slam.pgo.ba") as ba:
            cfg, mc = self.config, self.mc
            poses_list = self.dataset.pgo_poses if cfg.pgo_on else self.dataset.odom_poses
            n_poses = len(poses_list)
            window = min(cfg.ba_frame, n_poses - 1)
            if window < 2:
                return None
            window_start = n_poses - window
            poses_full = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
            poses_full[:n_poses] = np.stack(poses_list).astype(np.float32)
            num_iters = cfg.iters * 4
            idx = self.rand.ba_indices(self.frame_id, self.pool, self.mcfg.bs, num_iters)
            xi0 = torch.zeros((window, 6), dtype=torch.float32, device=self.device)
            with tracing.span("pin_slam.pgo.ba.loop"):
                feats, xi, hist = mp.bundle_adjustment_loop(
                    self.lm, mc, self.lm.geo_features, self.decoder, self.pool, self.mcfg,
                    self.offsets, self._f32_dev(poses_full, "poses"), window_start, xi0, idx)
                self._sync()
            tracing.count("ba.iters", num_iters)
            with tracing.span("pin_slam.pgo.ba.refresh"):
                self.lm.geo_features = feats
                self._write_back(self.lm)
                dT = tracing.read(se3_expmap(xi).double(), "ba_poses").numpy()
                before = np.stack(poses_list[window_start:])[:, :3, 3]
                for i in range(window):
                    poses_list[window_start + i] = dT[i] @ poses_list[window_start + i]
                shift = np.linalg.norm(np.stack(poses_list[window_start:])[:, :3, 3] - before,
                                       axis=1)
                self.cur_pose = poses_list[self.frame_id].copy()
                self.dataset.last_pose = self.cur_pose.copy()

                poses_new = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
                poses_new[:n_poses] = np.stack(poses_list).astype(np.float32)
                poses_d = self._f32_dev(poses_new, "poses")
                with tracing.span("pin_slam.pgo.ba.pool"):
                    self.pool = pool_kernel.pool_pass(self.pool, poses_d, self.state.attr_rows,
                                                      mc, mc.pos_encode)
                    self._sync()
            losses = tracing.read(hist, "ba_losses").numpy()
            out = {"window": window, "window_start": window_start, "iters": num_iters,
                   "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                   "loss_finite": bool(np.isfinite(losses).all()),
                   "mean_pose_shift_m": float(shift.mean())}
        out["ms"] = ba.ms
        return out

    def save_artifacts(self, run_path: str):
        """End-of-run artifacts: the final pose graph and loop plot, the
        finalised map (merge + prune, compacted), the time table and the
        map's size per frame, and as the configuration asks the implicit
        map, the neural-point and merged clouds, and the whole-map mesh.
        Returns ``mesh_map``'s (vertices, faces, view counts) with
        ``save_mesh``, else None.  Finalisation compacts ``self.state``: call
        this after the last frame.  Under map sharding the shards are first
        gathered into one dense map on every rank (``_densify_sharded_state``);
        with several ranks each computes the same artifacts (the mesh's
        queries split over the data-parallel ranks) and rank 0 alone writes
        them."""
        cfg = self.config
        write = self.is_writer
        if self.map_counts:
            # one read of the per-frame counts (under map sharding every
            # shard's, summed); MB as the JAX package writes them
            counts = torch.stack(self.map_counts)
            if self._spatial is not None and not self._dense:
                from pin_slam_torch.parallel import mesh as pmesh

                counts = pmesh.psum(self._spatial.mesh, counts)
            counts = counts.cpu().numpy()
        if self._spatial is not None and not self._dense:
            self._densify_sharded_state()
        if write:
            os.makedirs(os.path.join(run_path, "map"), exist_ok=True)
            if self.pgm is not None and self.pgm.pgo_count > 0:
                self.pgm.write_g2o(os.path.join(run_path, "final_pose_graph.g2o"))
                self.pgm.plot_loops(os.path.join(run_path, "loop_plot.png"))

        with torch.no_grad():
            self.state = npts.finalize_map(
                self.state, self.mc, self._travel, max(self.frame_id - 1, 0),
                prune_certainty_thre=float(cfg.max_prune_certainty),
                downsample_table_size=cfg.downsample_hash_size)
        if self.map_counts and write:
            point_dim = cfg.feature_dim + 3 + 4 + (cfg.feature_dim if cfg.color_on else 0)
            np.save(os.path.join(run_path, "memory_footprint.npy"),
                    counts * point_dim * 4 / 2**20)
        if self.stage_times and write:
            tt = np.asarray(self.stage_times)
            np.save(os.path.join(run_path, "time_table.npy"), tt)
            _plot_stage_times(os.path.join(run_path, "time_details.png"), tt)

        count = int(self.state.count)
        pts = self.state.positions[:count].cpu().numpy()
        if cfg.save_map and write:
            save_implicit_map(os.path.join(run_path, "map", "pin_map.npz"), self.state,
                              self.decoder, color_decoder=self.color_decoder,
                              sem_decoder=self.sem_decoder)
        if (cfg.save_merged_pc or cfg.save_map) and write:
            pio.write_ply(os.path.join(run_path, "map", "neural_points.ply"), pts,
                          extra={"certainty": self.state.attr_rows[:count, npts.C_CERT]
                                 .cpu().numpy()})
        if cfg.save_merged_pc and self.dataset.total_pc_count > 0 and write:
            self.dataset.write_merged_point_cloud(run_path, vox_down_m=3 * cfg.vox_down_m)
        mesh = None
        if cfg.save_mesh and count > 0:
            mesh = self.mesh_map(pts)
            verts, faces, _ = mesh
            if len(verts):
                if write:
                    os.makedirs(os.path.join(run_path, "mesh"), exist_ok=True)
                    pio.write_ply(os.path.join(run_path, "mesh", "mesh.ply"), verts,
                                  colors=self.mesh_colors,
                                  normals=vertex_normals(verts, faces), faces=faces)
                self._mesh_cache = (verts, faces, self.mesh_colors)
        if not write:
            return mesh
        # the self-contained viewer: the map's points, the last mesh (the
        # whole map's, else the last in-run one), the trajectory
        try:
            poses = self.dataset.pgo_poses if cfg.pgo_on else self.dataset.odom_poses
            traj = (np.stack([p[:3, 3] for p in poses]).astype(np.float32) if len(poses)
                    else None)
            mv, mf, mcol = self._mesh_cache
            export_html(os.path.join(run_path, "viewer.html"), neural_points=pts,
                        mesh_verts=mv, mesh_faces=mf, mesh_colors=mcol, trajectory=traj)
        except Exception as e:   # the viewer is an artifact, never a crash
            if not cfg.silence:
                print(f"[pipeline] viewer export failed: {e}")
        return mesh

    def _densify_sharded_state(self) -> None:
        """Map sharding: gather and compact every shard's points into one
        dense map in the merged layout (hash rebuilt) on every rank, so that
        the end of a run runs on it unchanged."""
        pos, attr, geo, col, _, count = self._spatial.gather_state_dense(self.state)
        mc, dev = self.mc, self.device
        cap = mc.capacity
        count = min(count, cap)
        dense = npts.init_map_state(mc, dev)
        dense.attr_rows[:count] = torch.as_tensor(attr[:count], device=dev)
        dense.geo_features[:count] = torch.as_tensor(geo[:count], device=dev)
        if col is not None and dense.color_features is not None:
            dense.color_features[:count] = torch.as_tensor(col[:count], device=dev)
        dense.count = torch.tensor(count, dtype=torch.int64, device=dev)
        self.state = npts.recreate_hash(dense, mc, max(self.frame_id - 1, 0),
                                        downsample_table_size=self.config.downsample_hash_size)
        self._dense = True

    def mesh_map(self, pts: np.ndarray):
        """The whole map's mesh from read-only radius views
        (``build_query_view``), one for each chunk of the map's extent.  The
        chunk size halves from 60 m until every chunk's view (a sphere of
        the chunk's half-diagonal plus the kNN reach) holds at most 0.7 of
        ``local_capacity`` points: a saturated view drops points and leaves
        holes.  Returns (vertices, faces, each chunk's view count); with a
        colour head the vertices' regressed colours are kept in
        ``self.mesh_colors``, with a semantic head their classes in
        ``self.mesh_sem_labels`` (else None).  The mesh file is written
        with the colours only, as the JAX package writes it."""
        cfg, mc = self.config, self.mc
        mesher = Mesher(MesherConfig(mc_res_m=cfg.mc_res_m, mesh_min_nn=cfg.mesh_min_nn,
                                     min_cluster_vertices=cfg.min_cluster_vertices,
                                     query_bucket=cfg.mesh_query_bucket),
                        mc, self.offsets, dp_mesh=self.dp_mesh)
        margin = float(np.sqrt(mc.max_valid_dist2)) + 1.0
        chunk_m = 60.0
        while chunk_m > 4.0:
            chunks = split_chunks(pts, chunk_m=chunk_m, pad=1.0)
            biggest = 0
            for a, b in chunks:
                center = (a + b) / 2.0
                radius = float(np.linalg.norm((b - a) / 2.0)) + margin
                biggest = max(biggest, int((np.linalg.norm(pts - center, axis=1)
                                            < radius).sum()))
            if biggest <= 0.7 * mc.local_capacity:
                break
            chunk_m /= 2.0
        view_counts = []

        def view(amin, amax):
            center = ((amin + amax) / 2).astype(np.float32)
            radius = float(np.linalg.norm((amax - amin) / 2)) + margin
            with torch.no_grad():
                v = npts.build_query_view(self.state, mc, self._f32_dev(center, "view_center"),
                                          np.float32(radius))
            view_counts.append(int(v.count))
            if view_counts[-1] >= mc.local_capacity and not cfg.silence and self.is_writer:
                print(f"[pipeline] save_mesh: chunk at {center} overflows local "
                      f"capacity {mc.local_capacity}; reduce chunk_m")
            return v

        out = mesher.recon_aabb_collections_mesh(view, self.decoder, self.sdf_scale, chunks,
                                                 color_decoder=self.color_decoder,
                                                 sem_decoder=self.sem_decoder)
        verts, faces = out[:2]
        self.mesh_colors, self.mesh_sem_labels = out[2:] if len(out) == 4 else (None, None)
        return verts, faces, view_counts

    def run(self, num_frames: Optional[int] = None) -> list:
        """Process the dataset's frames, then write the results (trajectory,
        with ground truth its metrics, kept in ``self.metrics``) and the
        end-of-run artifacts; returns each frame's info dict.  With several
        ranks rank 0 alone writes (and logs); every rank keeps the same
        state."""
        cfg = self.config
        if self.is_writer:
            wandb_log.setup_wandb(cfg)
        n = len(self.dataset) if num_frames is None else min(num_frames, len(self.dataset))
        end = cfg.end_frame if cfg.end_frame > 0 else n
        infos = []
        for i in range(cfg.begin_frame, min(end, n), max(cfg.every_frame, 1)):
            infos.append(self.process_frame(self.dataset.preprocess_frame(i)))
            if not cfg.silence and self.is_writer:
                print(f"frame {i}: {infos[-1]}", flush=True)
        run_path = self._run_path()
        self.metrics = self.dataset.write_results(run_path) if self.is_writer else {}
        self.save_artifacts(run_path)
        if self.metrics:
            wandb_log.log({f"metrics/{k}": v for k, v in self.metrics.items()})
        wandb_log.finish()
        return infos


def _plot_stage_times(path: str, tt: np.ndarray) -> None:
    """Stacked per-frame stage times with the 10 Hz line (skipped without
    matplotlib)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    labels = ["preprocess", "odometry", "map update", "map optimization", "loop & pgo"]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.stackplot(np.arange(tt.shape[0]), (tt * 1e3).T, labels=labels)
    ax.axhline(100.0, color="k", ls="--", lw=1, label="100 ms (10 Hz)")
    ax.set_xlabel("frame")
    ax.set_ylabel("time (ms)")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
