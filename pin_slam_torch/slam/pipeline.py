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
and the pool's re-derivation (``pool_retransform``, ``pool_refresh_cache``).
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

The JAX package fuses each stage into one jitted program; the port runs the
same operations eagerly on the device, with the pose hand-over and the
health-gate decisions on the host.  Every random draw comes from one
``RandomSource`` (a ``torch.Generator`` on the device); tests substitute the
JAX package's draws.

At the end of a run (``run`` -> ``save_artifacts``) the map is finalised
(merged and pruned) and, as the configuration asks, saved (``pin_map.npz``,
``neural_points.ply``), the merged point cloud written, and the whole map
meshed chunk by chunk on the device (``mesh/mesh.ply``).

Options this slice does not port raise ``NotImplementedError`` pointing at
ROADMAP.md; none is ignored silently.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pin_slam_torch.dataset import io as pio
from pin_slam_torch.dataset.slam_dataset import Frame, SLAMDataset
from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.decoder import Decoder
from pin_slam_torch.ops.marching_cubes import vertex_normals
from pin_slam_torch.ops.sampler import SamplerConfig, draw_ray_noise, sample_rays
from pin_slam_torch.ops.scatter import nonzero_static
from pin_slam_torch.ops.transforms import np_se3_inverse, se3_expmap
from pin_slam_torch.ops.voxel import voxel_down_sample_mask
from pin_slam_torch.slam import loop_detector as ld
from pin_slam_torch.slam import mapper as mp
from pin_slam_torch.slam import pgo as pgo_mod
from pin_slam_torch.slam import tracker as trk
from pin_slam_torch.slam.mesher import Mesher, MesherConfig, split_chunks
from pin_slam_torch.utils import wandb_log
from pin_slam_torch.utils.experiment import save_implicit_map
from pin_slam_torch.utils.platform import not_ported, resolve_device

TS_CAPACITY = 1 << 16


def check_ported(cfg) -> None:
    """Raise for every option this slice of the port does not cover."""
    unported = [
        ("dp_devices > 1 (data-parallel mapping and mesh queries, ROADMAP A 12)",
         cfg.dp_devices > 1),
        ("map_shards > 1 (ROADMAP A 12)", cfg.map_shards > 1),
        ("semantic_on (the head and vertex painting, ROADMAP A 11)", cfg.semantic_on),
        ("estimate_normal (ROADMAP A 11, normals)", cfg.estimate_normal),
        ("dynamic_filter_on (ROADMAP A 11, the dynamic filter)", cfg.dynamic_filter_on),
        ("pos_encoding_band > 0", cfg.pos_encoding_band > 0),
        ("o3d_vis_on (in-run mesh/SDF artifacts)", cfg.o3d_vis_on),
        ("layer_norm_on", cfg.layer_norm_on),
        # pool rows cache exactly 6 neighbours (P_KNN / P_W); a wider kNN
        # would overwrite the weight columns
        ("query_nn_k != 6 (pool rows sized from nn_k, ROADMAP C 2)", cfg.query_nn_k != 6),
        ("geo_mlp_level != 1 or mlp_bias_on = False",
         cfg.geo_mlp_level != 1 or not cfg.mlp_bias_on),
        # knobs the JAX package measured and rejected (PERF_TPU.md); kept
        # there at their defaults, not carried into the port
        ("fresh_freespace_damp < 1.0", cfg.fresh_freespace_damp < 1.0),
        ("probe_dedup_near_budget > 0", cfg.probe_dedup_near_budget > 0)]
    for name, on in unported:
        if on:
            raise not_ported(name)


class RandomSource:
    """Every random draw of the main path, from one ``torch.Generator``."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def ray_noise(self, frame_id: int, sc: SamplerConfig, n: int):
        return draw_ray_noise(self.gen, sc, n, self.device)

    def batch_indices(self, frame_id: int, chunk: int, pool: mp.PoolState,
                      mcfg: mp.MapperConfig, use_new: bool, num_iters: int):
        """chunk -1: the frame's main training, -2: a stop frame's training,
        0..: frame-0 extra chunks (tests key the JAX package's draws on it)."""
        return mp.sample_batch_indices(self.gen, pool, mcfg,
                                       torch.tensor(use_new, device=self.device), num_iters)

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
    ``device="cpu"`` to run the kernels' plain PyTorch versions on the CPU."""

    def __init__(self, config, dataset: Optional[SLAMDataset] = None,
                 device=None, random_source: Optional[RandomSource] = None,
                 sync_stages: bool = False):
        cfg = self.config = config
        check_ported(cfg)
        self.device = dev = resolve_device(device)
        self.dataset = dataset if dataset is not None else SLAMDataset(cfg, device=dev)
        if self.dataset.device is None:
            self.dataset.device = dev
        self.mc = npts.MapConfig.from_config(cfg)
        self.mcfg = mp.MapperConfig.from_config(cfg)
        self.sc = SamplerConfig.from_config(cfg)
        self.tc = trk.TrackerConfig.from_config(cfg)
        if not mp.kernel_path_supported(self.mcfg, cfg):
            raise not_ported("training configuration outside the kernel path")
        self.sync_stages = sync_stages
        self.rand = random_source or RandomSource(cfg.seed, dev)

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
        self.decoder = Decoder(cfg.feature_dim + 3, cfg.geo_mlp_hidden_dim,
                               cfg.geo_mlp_level, 1, cfg.mlp_bias_on, generator=gen,
                               device=dev)
        self.decoder.requires_grad_(False)
        self.color_decoder = None
        if cfg.color_on:
            self.color_decoder = Decoder(cfg.feature_dim + 3, cfg.color_mlp_hidden_dim,
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

        self.state = npts.init_map_state(self.mc, dev)
        self.lm = npts.init_local_map(self.mc, dev)
        self.pool = mp.init_pool(self.mcfg, dev, color_channel=max(cfg.color_channel, 1))
        self.sdf_scale = cfg.sdf_scale
        self.cur_pose = np.eye(4)
        if self.dataset.gt_pose_provided and cfg.track_on:
            self.cur_pose = self.dataset.gt_poses[cfg.begin_frame].copy()
            self.dataset.last_pose = self.cur_pose.copy()
        self.lm_origin64 = np.zeros(3)
        self.frame_id = 0
        self.stage_times = []      # [preprocess, odometry, map update, training, pgo]
        self.map_counts = []       # the map's count after each frame, device scalars
        self.mesh_colors = None    # the last whole-map mesh's vertex colours (colour head)
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
        self.last_source = None        # the frame's source cloud, for loop verification
        self.last_reg_cov = None

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.sync_stages and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def _frame_update(self, points, valid, pose_R, pose_t, frame_id, colors=None):
        """Sample -> insert -> local map -> new flags -> kNN probe -> pool
        append (with ``colors`` (B, C), the samples' colour labels too)."""
        cfg, mc, mcfg, sc = self.config, self.mc, self.mcfg, self.sc
        dev = self.device
        if not cfg.rand_downsample:
            valid = valid & voxel_down_sample_mask(points, valid, cfg.vox_down_m,
                                                   cfg.downsample_hash_size)
        if cfg.mapping_bucket and cfg.mapping_bucket < points.shape[0]:
            Mb = cfg.mapping_bucket
            cidx = nonzero_static(valid, Mb, points.shape[0])
            n_val = torch.sum(valid)
            points = torch.cat([points, torch.zeros((1, 3), device=dev)])[cidx]
            valid = torch.arange(Mb, device=dev) < torch.clamp(n_val, max=Mb)
            if colors is not None:
                colors = torch.cat([colors, colors.new_zeros((1, colors.shape[1]))])[cidx]
        batch = sample_rays(sc, points, valid, self.rand.ray_noise(frame_id, sc, points.shape[0]),
                            colors)
        coord_world = batch.coord @ pose_R.T + pose_t
        Sn, n_surf_tot = sc.ray_sample_count, 1 + sc.surface_sample_n
        cw_surf = coord_world.reshape(-1, Sn, 3)[:, :n_surf_tot].reshape(-1, 3)
        lbl_surf = batch.sdf_label.reshape(-1, Sn)[:, :n_surf_tot].reshape(-1)
        vld_surf = batch.valid.reshape(-1, Sn)[:, :n_surf_tot].reshape(-1)
        surf_mask = vld_surf & (torch.abs(lbl_surf)
                                < cfg.surface_sample_range_m * cfg.map_surface_ratio)
        self.state = npts.map_insert(
            self.state, mc, cw_surf, surf_mask, frame_id, self._travel,
            downsample_table_size=cfg.downsample_hash_size,
            insert_bucket=min(cfg.frame_bucket, cw_surf.shape[0]))
        lm = npts.build_local_map(self.state, mc, pose_t, frame_id, self._travel)

        new_full = mp.compute_new_sample_mask(lm, mc, mcfg, coord_world, batch.sdf_label,
                                              batch.valid)
        col = torch.arange(Sn, device=dev) < n_surf_tot
        new_mask = (new_full.reshape(-1, Sn) & col[None, :]).reshape(-1)
        n_rays_f = coord_world.shape[0] // Sn
        n_far = n_rays_f * (Sn - 1 - sc.surface_sample_n)
        gidx, w, vec, nvec, dropped = mp.append_knn(
            lm, mc, self.append_tmpl, coord_world, Sn, near_count=n_surf_tot,
            far_offsets=self.far_tmpl, per_neighbor_vecs=not mcfg.weighted_first,
            dedup_far_budget=int(n_far * cfg.probe_dedup_budget) if self._use_dedup else 0,
            quats=self.state.attr_rows[:, npts.C_QUAT] if self.after_pgo else None)
        self.pool = mp.pool_append(self.pool, mcfg, coord_world, batch.coord,
                                   batch.sdf_label, batch.weight, batch.valid & ~dropped,
                                   frame_id, new_mask, gidx, w, vec, nvec,
                                   color_label=batch.color_label)
        return lm

    def _train(self, lm, feats, gvec, opt, frame_id, chunk, use_new, dec_scale, num_iters,
               color=None):
        """``num_iters`` Adam iterations on ``lm``; returns (lm_out, feats, gvec,
        opt, loss history) with lm_out's features (and, with the colour
        state ``color``, its colour features) set to the trained ones."""
        idx = self.rand.batch_indices(frame_id, chunk, self.pool, self.mcfg, use_new, num_iters)
        lm2, feats, gvec, opt, hist = mp.mapping_loop_cached(
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
        cfg, dev = self.config, self.device
        info = {}
        with torch.no_grad():
            t0 = time.perf_counter()
            points = torch.as_tensor(frame.points, dtype=torch.float32, device=dev)
            valid = torch.as_tensor(frame.valid, device=dev)
            colors = (torch.as_tensor(frame.colors, dtype=torch.float32, device=dev)
                      if cfg.color_on and frame.colors is not None else None)
            tracked = cfg.track_on and self.frame_id > 0
            # detection frames settle the pose books (and a loop closure may
            # replace the pose) before the map update
            detect_due = (self.pgm is not None and self.frame_id > 0
                          and self.frame_id % max(cfg.pgo_freq, 1) == 0)
            ba_due = (cfg.ba_freq_frame > 0 and self.frame_id > cfg.ba_frame // 2
                      and (self.frame_id + 1) % cfg.ba_freq_frame == 0)
            conservative = (not tracked or detect_due or ba_due
                            or (self.frame_id > 0 and self.dataset.stop_status))
            pgo_pre = pgo_post = 0.0

            t1 = time.perf_counter()
            booked = None
            if tracked:
                init_pose = self.dataset.initial_guess()
                origin64 = self.lm_origin64
                R_init = torch.as_tensor(init_pose[:3, :3], dtype=torch.float32)
                t_init = torch.as_tensor(init_pose[:3, 3] - origin64, dtype=torch.float32)
                src, src_valid, *src_col = self._source_prep(points, valid, colors)
                self.last_source = (src, src_valid)
                res = trk.track_frame(self.lm, self.mc, self.tc, self.decoder, self.sdf_scale,
                                      self.append_tmpl, src, src_valid, R_init, t_init,
                                      after_pgo=self.after_pgo,
                                      color_decoder=self.color_decoder,
                                      source_colors=src_col[0] if src_col else None)
                # pose selection in float32, as the JAX package does on device
                origin = self.lm.origin.cpu()
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
            else:
                if not cfg.track_on and self.dataset.gt_pose_provided:
                    self.cur_pose = self.dataset.gt_poses[self.frame_id].copy()
                self.dataset.update_odom_pose(self.cur_pose, True)
                self.last_reg_cov = None
                ok = True

            if self.loop_mgr is not None and tracked and not conservative:
                # descriptor of the PRE-update local map at the selected pose
                tp = time.perf_counter()
                feats = self.lm.geo_features if cfg.loop_with_feature else None
                self.loop_mgr.add_node_device(self.frame_id, self.lm.positions, self.lm.count,
                                              R_sel, t_w, feats)
                self._sync()
                pgo_pre += time.perf_counter() - tp

            if conservative:
                if booked is not None:
                    booked()
                    booked = None
                if self.pgm is not None and not self.dataset.lose_track:
                    tp = time.perf_counter()
                    self._loop_closure_stage(info)
                    self._sync()
                    pgo_pre += time.perf_counter() - tp
                if self.dataset.lose_track:
                    t2 = time.perf_counter()
                    self.stage_times.append([t1 - t0, t2 - t1 - pgo_pre, 0.0, 0.0, pgo_pre])
                    self.dataset.time_table.append(self.stage_times[-1])
                    self.frame_id += 1
                    info["skipped"] = True
                    return info
                if ba_due:
                    # bundle adjustment's time is the back end's (the pgo column)
                    tp = time.perf_counter()
                    info["ba"] = self._bundle_adjustment()
                    self._sync()
                    pgo_pre += time.perf_counter() - tp
                R_sel = torch.as_tensor(self.cur_pose[:3, :3], dtype=torch.float32)
                t_w = torch.as_tensor(self.cur_pose[:3, 3], dtype=torch.float32)
                ok = True
                td = self.dataset.travel_dist
                tran_sel = float(np.float32(td[-1] - td[-2])) if len(td) > 1 else 0.0
            self._sync()

            t2 = time.perf_counter()
            fid = self.frame_id
            dec_scale = 0.0 if fid >= cfg.freeze_after_frame else 1.0
            R_d, t_d = R_sel.to(dev), t_w.to(dev)
            self._travel_step(fid, tran_sel)
            stop_frame = fid > 0 and self.dataset.stop_status
            gvec = self.decoder.pack()
            if stop_frame:
                n_it = max(1, cfg.iters - 10) if cfg.adaptive_mode else int(cfg.iters)
                feats = self._with_cert_column(self.lm)
                opt = mp.init_opt_state(feats, gvec)
                color = self._color_state(self.lm)
                lm_out, feats, gvec, opt, hist = self._train(
                    self.lm, feats, gvec, opt, fid, -2, False, dec_scale, n_it, color)
                t_map = time.perf_counter()
            else:
                self._stop_count = (self._stop_count + 1
                                    if tran_sel < 0.01 * cfg.voxel_size_m else 0)
                use_new = ok and not (self._stop_count > cfg.stop_frame_thre)
                lm2 = self._frame_update(points, valid & ok, R_d, t_d, fid, colors)
                self._sync()
                t_map = time.perf_counter()
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
            self.state = npts.assign_local_to_global(self.state, lm_out, self.mc, self._travel)
            self.lm = lm_out
            self.decoder.load_packed(gvec)
            if color is not None and hist is not None:
                color.load_into(self.color_decoder)

            if booked is not None:
                booked()
                if self.pgm is not None:
                    tp = time.perf_counter()
                    if self.dataset.lose_track:
                        if self.loop_mgr is not None:
                            self.loop_mgr.drop_pending(fid)
                    else:
                        self._pgo_bookkeeping(fid)
                    pgo_post += time.perf_counter() - tp
            self.lm_origin64 = self.cur_pose[:3, 3].copy()
            if (fid + 1) % cfg.pool_filter_freq == 0:
                self.pool = mp.pool_filter(self.pool, self.mcfg, t_d)

            extra_chunks = cfg.init_iter_ratio - 1 if fid == 0 else 0
            for chunk in range(extra_chunks):
                self.lm, feats, gvec, opt, hist = self._train(
                    self.lm, feats, gvec, opt, fid, chunk, True, dec_scale, int(cfg.iters),
                    color)
                self.state = npts.assign_local_to_global(self.state, self.lm, self.mc,
                                                         self._travel)
                self.decoder.load_packed(gvec)
                if color is not None:
                    color.load_into(self.color_decoder)
            if cfg.log_loss_per_frame and hist is not None:
                info["loss_last"] = float(hist[-1])
                info["loss_finite"] = bool(torch.isfinite(hist).all())
            self._sync()
            t3 = time.perf_counter()

        self.stage_times.append([t1 - t0, t2 - t1 - pgo_pre, t_map - t2,
                                 t3 - t_map - pgo_post, pgo_pre + pgo_post])
        self.dataset.time_table.append(self.stage_times[-1])
        st = self.stage_times[-1]
        wandb_log.log({"timing(s)/preprocess": st[0], "timing(s)/tracking": st[1],
                       "timing(s)/mapping": st[2] + st[3], "timing(s)/pgo": st[4],
                       **({"loss/loss_last": info["loss_last"]} if "loss_last" in info
                          else {})},
                      step=self.frame_id)
        if self.pgm is not None:
            info["pgo_s"] = pgo_pre + pgo_post
        # kept on the device (no host sync a frame); read once at save time
        self.map_counts.append(self.state.count)
        self.frame_id += 1
        return info

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

    def _f32_dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _loop_closure_stage(self, info: dict) -> None:
        """The pose-graph stage of a conservative frame: bookkeeping and the
        frame's descriptor, and on detection frames loop detection,
        verification, optimisation and map deformation."""
        cfg, mc = self.config, self.mc
        fid = self.frame_id
        pgm = self.pgm
        travel = self.dataset.travel_dist
        cur = self.dataset.pgo_poses[fid].copy()

        self._pgo_bookkeeping(fid)
        drift = pgm.estimate_drift(travel, fid)
        if self.loop_mgr is not None and fid > 0:
            feats = self.lm.geo_features if cfg.loop_with_feature else None
            self.loop_mgr.add_node_device(fid, self.lm.positions, self.lm.count,
                                          self._f32_dev(cur[:3, :3]), self._f32_dev(cur[:3, 3]),
                                          feats)
        if fid == 0 or fid % max(cfg.pgo_freq, 1) != 0 or self.last_source is None:
            return
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
        lm_loop = npts.build_local_map(self.state, mc, self._f32_dev(origin_loop), loop_id,
                                       self._travel, travel_window=float(tw))
        source, src_valid = self.last_source
        res = trk.track_frame(
            lm_loop, mc, self.tc_loop, self.decoder, self.sdf_scale, self.append_tmpl,
            source, src_valid, torch.as_tensor(guess[:3, :3].astype(np.float32)),
            torch.as_tensor((guess[:3, 3] - origin_loop).astype(np.float32)),
            after_pgo=self.after_pgo)
        if not res.valid:
            self.loop_reg_failed_count += 1
            info["loop_verified"] = False
            return
        info["loop_verified"] = True

        T_cur = np.eye(4)
        T_cur[:3, :3] = res.R.double().numpy()
        T_cur[:3, 3] = res.t.double().numpy() + origin_loop
        cov = res.cov.double().numpy() if cfg.use_reg_cov_mat else None
        pgm.add_loop_factor(fid, loop_id, np_se3_inverse(loop_pose) @ T_cur, cov)
        pgm.last_loop_idx = fid

        # optimise, then deform the map and re-derive the pool
        new_poses = pgm.optimize_pose_graph()
        pose_diff = pgm.get_pose_diff(poses)
        diff_full = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
        diff_full[:pose_diff.shape[0]] = pose_diff.astype(np.float32)
        self.state = npts.adjust_map(self.state, mc, self._f32_dev(diff_full))
        self.state = npts.recreate_hash(self.state, mc, fid,
                                        downsample_table_size=cfg.downsample_hash_size)
        poses_full = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
        poses_full[:new_poses.shape[0]] = new_poses.astype(np.float32)
        self.pool = mp.pool_retransform(self.pool, self._f32_dev(poses_full))
        self.pool = mp.pool_refresh_cache(self.pool, self.state.attr_rows, mc)

        self.dataset.update_poses_after_pgo(new_poses)
        self.cur_pose = new_poses[fid].copy()
        self.lm = npts.build_local_map(self.state, mc, self._f32_dev(self.cur_pose[:3, 3]),
                                       fid, self._travel)
        self.lm_origin64 = self.cur_pose[:3, 3].copy()
        self.after_pgo = True
        self.loop_reg_failed_count = 0
        info["pgo_applied"] = True

    def _bundle_adjustment(self) -> Optional[dict]:
        """Refine the last ``ba_frame`` poses (frame 0 stays fixed) and the
        local features jointly (``mapper.bundle_adjustment_loop``, 4 x
        ``iters`` iterations), write the poses back, then re-derive the
        pool's coordinates and cached kNN geometry (the map points do not
        move).  Returns the call's window, losses, mean pose shift and
        wall time, or None for a window under two poses."""
        cfg, mc = self.config, self.mc
        t0 = time.perf_counter()
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
        feats, xi, hist = mp.bundle_adjustment_loop(
            self.lm, mc, self.lm.geo_features, self.decoder, self.pool, self.mcfg,
            self.offsets, self._f32_dev(poses_full), window_start, xi0, idx)
        self.lm.geo_features = feats
        self.state = npts.assign_local_to_global(self.state, self.lm, mc, self._travel)
        dT = se3_expmap(xi).double().cpu().numpy()
        before = np.stack(poses_list[window_start:])[:, :3, 3]
        for i in range(window):
            poses_list[window_start + i] = dT[i] @ poses_list[window_start + i]
        shift = np.linalg.norm(np.stack(poses_list[window_start:])[:, :3, 3] - before, axis=1)
        self.cur_pose = poses_list[self.frame_id].copy()
        self.dataset.last_pose = self.cur_pose.copy()

        poses_new = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
        poses_new[:n_poses] = np.stack(poses_list).astype(np.float32)
        self.pool = mp.pool_retransform(self.pool, self._f32_dev(poses_new))
        self.pool = mp.pool_refresh_cache(self.pool, self.state.attr_rows, mc)
        self._sync()
        losses = hist.cpu().numpy()
        return {"window": window, "window_start": window_start, "iters": num_iters,
                "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                "loss_finite": bool(np.isfinite(losses).all()),
                "mean_pose_shift_m": float(shift.mean()),
                "ms": (time.perf_counter() - t0) * 1e3}

    def save_artifacts(self, run_path: str):
        """End-of-run artifacts: the final pose graph and loop plot, the
        finalised map (merge + prune, compacted), the time table and the
        map's size per frame, and as the configuration asks the implicit
        map, the neural-point and merged clouds, and the whole-map mesh.
        Returns ``mesh_map``'s (vertices, faces, view counts) with
        ``save_mesh``, else None.  Finalisation compacts ``self.state``: call
        this after the last frame."""
        cfg = self.config
        os.makedirs(os.path.join(run_path, "map"), exist_ok=True)
        if self.pgm is not None and self.pgm.pgo_count > 0:
            self.pgm.write_g2o(os.path.join(run_path, "final_pose_graph.g2o"))
            self.pgm.plot_loops(os.path.join(run_path, "loop_plot.png"))

        with torch.no_grad():
            self.state = npts.finalize_map(
                self.state, self.mc, self._travel, max(self.frame_id - 1, 0),
                prune_certainty_thre=float(cfg.max_prune_certainty),
                downsample_table_size=cfg.downsample_hash_size)
        if self.map_counts:
            # one read of the per-frame counts; MB as the JAX package writes them
            counts = torch.stack(self.map_counts).cpu().numpy()
            point_dim = cfg.feature_dim + 3 + 4 + (cfg.feature_dim if cfg.color_on else 0)
            np.save(os.path.join(run_path, "memory_footprint.npy"),
                    counts * point_dim * 4 / 2**20)
        if self.stage_times:
            tt = np.asarray(self.stage_times)
            np.save(os.path.join(run_path, "time_table.npy"), tt)
            _plot_stage_times(os.path.join(run_path, "time_details.png"), tt)

        count = int(self.state.count)
        pts = self.state.positions[:count].cpu().numpy()
        if cfg.save_map:
            save_implicit_map(os.path.join(run_path, "map", "pin_map.npz"), self.state,
                              self.decoder, color_decoder=self.color_decoder)
        if cfg.save_merged_pc or cfg.save_map:
            pio.write_ply(os.path.join(run_path, "map", "neural_points.ply"), pts,
                          extra={"certainty": self.state.attr_rows[:count, npts.C_CERT]
                                 .cpu().numpy()})
        if cfg.save_merged_pc and self.dataset.total_pc_count > 0:
            self.dataset.write_merged_point_cloud(run_path, vox_down_m=3 * cfg.vox_down_m)
        mesh = None
        if cfg.save_mesh and count > 0:
            mesh = self.mesh_map(pts)
            verts, faces, _ = mesh
            if len(verts):
                os.makedirs(os.path.join(run_path, "mesh"), exist_ok=True)
                pio.write_ply(os.path.join(run_path, "mesh", "mesh.ply"), verts,
                              colors=self.mesh_colors, normals=vertex_normals(verts, faces),
                              faces=faces)
        if not cfg.silence:
            print(f"[pipeline] {not_ported('viewer.html export (ROADMAP A 11)')}", flush=True)
        return mesh

    def mesh_map(self, pts: np.ndarray):
        """The whole map's mesh from read-only radius views
        (``build_query_view``), one for each chunk of the map's extent.  The
        chunk size halves from 60 m until every chunk's view (a sphere of
        the chunk's half-diagonal plus the kNN reach) holds at most 0.7 of
        ``local_capacity`` points: a saturated view drops points and leaves
        holes.  Returns (vertices, faces, each chunk's view count); with a
        colour head the vertices' regressed colours are kept in
        ``self.mesh_colors`` (else None)."""
        cfg, mc = self.config, self.mc
        mesher = Mesher(MesherConfig(mc_res_m=cfg.mc_res_m, mesh_min_nn=cfg.mesh_min_nn,
                                     min_cluster_vertices=cfg.min_cluster_vertices,
                                     query_bucket=cfg.mesh_query_bucket),
                        mc, self.offsets)
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
                v = npts.build_query_view(self.state, mc, self._f32_dev(center),
                                          np.float32(radius))
            view_counts.append(int(v.count))
            if view_counts[-1] >= mc.local_capacity and not cfg.silence:
                print(f"[pipeline] save_mesh: chunk at {center} overflows local "
                      f"capacity {mc.local_capacity}; reduce chunk_m")
            return v

        out = mesher.recon_aabb_collections_mesh(view, self.decoder, self.sdf_scale, chunks,
                                                 color_decoder=self.color_decoder)
        verts, faces = out[:2]
        self.mesh_colors = out[2] if self.color_decoder is not None else None
        return verts, faces, view_counts

    def run(self, num_frames: Optional[int] = None) -> list:
        """Process the dataset's frames, then write the results (trajectory,
        with ground truth its metrics, kept in ``self.metrics``) and the
        end-of-run artifacts; returns each frame's info dict."""
        cfg = self.config
        wandb_log.setup_wandb(cfg)
        n = len(self.dataset) if num_frames is None else min(num_frames, len(self.dataset))
        end = cfg.end_frame if cfg.end_frame > 0 else n
        infos = []
        for i in range(cfg.begin_frame, min(end, n), max(cfg.every_frame, 1)):
            infos.append(self.process_frame(self.dataset.preprocess_frame(i)))
            if not cfg.silence:
                print(f"frame {i}: {infos[-1]}", flush=True)
        run_path = cfg.run_path or os.path.join(cfg.output_root, cfg.name or "run")
        self.metrics = self.dataset.write_results(run_path)
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
