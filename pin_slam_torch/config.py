"""Configuration system (the PyTorch port's own copy of
``pin_slam_tpu/config.py``; the port imports nothing from the JAX package).

Feature-parity with the upstream PIN-SLAM config (its utils/config.py):
same attribute names and YAML section layout (``setting/process/sampler/neuralpoints/
decoder/loss/continual/tracker/pgo/optimizer/eval``) so existing PIN-SLAM YAML profiles
port over unchanged.  On top of that, TPU-specific static-shape capacities are added
(XLA requires fixed shapes; the reference grows tensors per frame with torch.cat,
model/neural_points.py:248-268 — here every buffer is pre-allocated and bucketed).
"""

from __future__ import annotations

import os
from typing import List, Optional

import yaml


class Config:
    """Typed defaults + YAML loader with section-wise overrides.

    Mirrors the reference's ~200 attributes (utils/config.py:11-325) with identical
    defaults; TPU additions are grouped at the end and prefixed in the YAML under an
    optional ``tpu`` section.
    """

    def __init__(self) -> None:
        # ---------------- settings ----------------
        self.name: str = "dummy"
        self.run_path: str = ""
        self.output_root: str = "./experiments"
        self.pc_path: str = ""
        self.pose_path: str = ""
        self.calib_path: str = ""
        self.label_path: str = ""
        self.closed_pose_path: Optional[str] = None

        self.load_model: bool = False
        self.model_path: str = "/"

        self.first_frame_ref: bool = False
        self.begin_frame: int = 0
        self.end_frame: int = 0
        self.every_frame: int = 1

        self.seed: int = 42
        self.device: str = "cuda"  # torch device: "cuda" or "cpu"
        self.pos_dtype: str = "float32"  # device point dtype
        # poses / transforms are always tracked in float64 on host (numpy)

        self.adaptive_mode: bool = False

        # dataset specific
        self.kitti_correction_on: bool = False
        self.correction_deg: float = 0.0

        # motion undistortion
        self.deskew: bool = False
        self.valid_ts_in_points: bool = True
        self.lidar_type_guess: str = "velodyne"

        # ---------------- process ----------------
        self.min_range: float = 2.5
        self.max_range: float = 60.0
        self.adaptive_range_on: bool = False
        self.min_z: float = -4.0
        self.max_z: float = 60.0

        self.rand_downsample: bool = False
        self.vox_down_m: float = 0.05
        self.rand_down_r: float = 1.0

        self.filter_noise: bool = False
        self.sor_nn: int = 25
        self.sor_std: float = 2.5

        self.estimate_normal: bool = False

        # semantic related
        self.semantic_on: bool = False
        self.sem_class_count: int = 20
        self.sem_label_decimation: int = 1
        self.freespace_label_on: bool = False
        self.filter_moving_object: bool = True

        # color (intensity) related
        self.color_map_on: bool = False
        self.color_on: bool = False
        self.color_channel: int = 0

        # ---------------- neural points ----------------
        self.weighted_first: bool = True
        self.layer_norm_on: bool = False
        self.voxel_size_m: float = 0.3
        self.max_points_per_voxel: int = 1
        # TPU: optional SMALLER probe template for individually-probed
        # free-space samples in the append-time kNN (0 = use the full
        # num_nei_cells template).  Free-front samples dominate the probe's
        # gathered rows; see mapper.append_knn.
        self.far_num_nei_cells: int = 0
        self.far_search_alpha: float = 0.6
        self.num_nei_cells: int = 2
        self.query_nn_k: int = 6
        self.use_mid_ts: bool = False
        self.search_alpha: float = 0.2
        self.idw_index: int = 2
        self.buffer_size: int = int(5e7)

        self.feature_dim: int = 8
        self.feature_std: float = 0.0

        self.from_sample_points: bool = True
        self.from_all_samples: bool = False
        self.map_surface_ratio: float = 0.5

        # local map
        self.diff_ts_local: float = 400.0
        self.local_map_travel_dist_ratio: float = 5.0
        self.local_map_radius: float = 50.0

        # map management
        self.prune_map_on: bool = False
        self.max_prune_certainty: float = 2.0

        # positional encoding (off by default, reference parity)
        self.use_gaussian_pe: bool = False
        self.pos_encoding_freq: int = 200
        self.pos_encoding_band: int = 0
        self.pos_input_dim: int = 3
        self.pos_encoding_base: int = 2

        # ---------------- sampler ----------------
        self.surface_sample_range_m: float = 0.25
        self.surface_sample_n: int = 3
        self.free_sample_begin_ratio: float = 0.3
        self.free_sample_end_dist_m: float = 1.0
        self.free_front_n: int = 2
        self.free_behind_n: int = 1

        # ---------------- replay pool ----------------
        self.window_radius: float = 50.0
        self.pool_capacity: int = int(1e7)
        self.bs_new_sample: int = 2048
        self.new_certainty_thre: float = 1.0
        self.pool_filter_freq: int = 10
        self.new_sample_ratio_thre: float = 0.01

        # ---------------- tracking ----------------
        self.track_on: bool = True
        self.photometric_loss_on: bool = False
        self.photometric_loss_weight: float = 0.01
        self.source_vox_down_m: float = 0.8
        self.uniform_motion_on: bool = True
        self.reg_min_grad_norm: float = 0.5
        self.reg_max_grad_norm: float = 2.0
        self.max_sdf_ratio: float = 5.0
        self.max_sdf_std_ratio: float = 1.0
        self.reg_dist_div_grad_norm: bool = False
        self.reg_GM_dist_m: float = 0.5
        self.reg_GM_grad: float = 0.2
        self.reg_lm_lambda: float = 1e-4
        self.reg_iter_n: int = 50
        self.reg_term_thre_deg: float = 0.01
        self.reg_term_thre_m: float = 0.0005
        self.eigenvalue_check: bool = True
        self.consist_wieght_on: bool = True  # (sic) reference spelling, kept for YAML parity

        self.stop_frame_thre: int = 20

        # ---------------- decoder ----------------
        self.mlp_bias_on: bool = True
        self.geo_mlp_level: int = 1
        self.geo_mlp_hidden_dim: int = 64
        self.sem_mlp_level: int = 1
        self.sem_mlp_hidden_dim: int = 64
        self.color_mlp_level: int = 1
        self.color_mlp_hidden_dim: int = 64
        self.freeze_after_frame: int = 40

        # ---------------- loss ----------------
        self.main_loss_type: str = "bce"
        self.sigma_sigmoid_m: float = 0.1
        self.sigma_scale_constant: float = 0.0
        self.logistic_gaussian_ratio: float = 0.55
        self.proj_correction_on: bool = False
        self.predict_sdf: bool = False
        self.loss_weight_on: bool = False
        self.behind_dropoff_on: bool = False
        self.dist_weight_on: bool = True
        self.dist_weight_scale: float = 0.8
        self.dropoff_min_sigma: float = 1.0
        self.dropoff_max_sigma: float = 8.0
        self.normal_loss_on: bool = False
        self.weight_n: float = 0.01

        self.numerical_grad: bool = True
        self.gradient_decimation: int = 10
        self.num_grad_step_ratio: float = 0.2

        self.ekional_loss_on: bool = True
        self.ekional_add_to: str = "all"
        self.weight_e: float = 0.5

        self.consistency_loss_on: bool = False
        self.weight_c: float = 0.5
        self.consistency_count: int = 1000
        self.consistency_range: float = 0.05

        self.weight_s: float = 1.0
        self.weight_i: float = 1.0

        self.dynamic_filter_on: bool = False
        self.dynamic_certainty_thre: float = 4.0
        self.dynamic_sdf_ratio_thre: float = 1.5

        # ---------------- optimizer ----------------
        self.mapping_freq_frame: int = 1
        self.ba_freq_frame: int = 0
        self.ba_frame: int = 50

        self.iters: int = 15
        self.init_iter_ratio: int = 40
        self.opt_adam: bool = True
        self.bs: int = 16384
        self.lr: float = 0.01
        self.lr_pose: float = 1e-3
        self.weight_decay: float = 0.0
        self.adam_eps: float = 1e-15

        # ---------------- loop closure ----------------
        self.global_loop_on: bool = False
        self.local_map_context: bool = False
        self.loop_with_feature: bool = False
        self.min_loop_travel_dist_ratio: float = 4.0
        self.local_map_context_latency: int = 0
        self.loop_local_map_time_window: int = 100
        self.context_shape: List[int] = [20, 60]
        self.context_num_candidates: int = 1
        self.context_cosdist_threshold: float = 0.2
        self.context_virtual_side_count: int = 4
        self.loop_z_check_on: bool = False
        self.use_gt_loop: bool = False
        self.max_loop_dist: float = 8.0

        # ---------------- pose graph optimization ----------------
        self.pgo_on: bool = False
        self.pgo_freq: int = 30
        self.pgo_with_lm: bool = True
        self.pgo_max_iter: int = 50
        self.pgo_with_pose_prior: bool = False
        self.pgo_tran_std: float = 0.04
        self.pgo_rot_std: float = 0.01
        self.use_reg_cov_mat: bool = False
        self.pgo_merge_map: bool = False
        self.rehash_with_time: bool = True

        # ---------------- ROS node (ref utils/config.py:321-324) ----------------
        self.publish_np_map: bool = True
        self.publish_np_map_down_rate_list = [11, 23, 37, 53, 71, 89, 97,
                                              113, 131, 151]  # prime strides
        self.republish_raw_input: bool = False
        self.timeout_duration_s: int = 30

        # ---------------- eval / vis ----------------
        self.wandb_vis_on: bool = False
        self.silence: bool = True
        self.o3d_vis_on: bool = False  # no interactive o3d on TPU hosts; artifact dumps instead
        self.o3d_vis_raw: bool = False
        # sensor CAD glyph for the viewer (ref utils/config.py sensor_cad_path,
        # utils/visualizer.py sensor model); "" -> generic lidar glyph
        self.sensor_cad_path: str = ""
        self.eval_on: bool = False
        self.eval_outlier_thre: float = 0.5
        self.eval_freq_iters: int = 100
        self.vis_freq_iters: int = 100
        self.save_freq_iters: int = 100
        self.mesh_freq_frame: int = 10
        self.sdfslice_freq_frame: int = 1
        self.vis_sdf_slice_v: bool = False
        self.sdf_slice_height: float = -1.0
        self.eval_traj_align: bool = True

        # ---------------- marching cubes ----------------
        self.mc_res_m: float = 0.1
        self.pad_voxel: int = 2
        self.skip_top_voxel: int = 2
        self.mc_mask_on: bool = True
        self.mc_local: bool = False
        self.mesh_min_nn: int = 8
        self.min_cluster_vertices: int = 200
        self.keep_local_mesh: bool = False
        self.infer_bs: int = 4096

        self.save_map: bool = False
        self.save_merged_pc: bool = False
        self.save_mesh: bool = False

        # ---------------- static-shape capacities ----------------
        # Every buffer is pre-allocated at these sizes (the JAX package needs
        # static shapes for XLA; the port keeps the same layouts so the two
        # packages can be compared row for row).
        self.map_capacity: int = 1 << 21          # max global neural points
        self.local_map_capacity: int = 1 << 18    # max neural points in the local map
        self.frame_bucket: int = 1 << 17          # padded per-frame point cloud size
        self.source_bucket: int = 1 << 13         # padded registration source cloud size
        self.insert_bucket: int = 1 << 16         # padded per-frame map-insert batch
        self.downsample_hash_size: int = 1 << 20  # scratch hash for voxel downsampling
        self.mesh_query_bucket: int = 1 << 18     # padded chunk for mesh grid queries
        # data-parallel devices for the mapping loop + mesh queries (1 = off;
        # >1 requires that many visible JAX devices — batch sharded over a
        # jax.sharding.Mesh, map/decoder replicated, grad psum over ICI)
        self.dp_devices: int = 1
        # Pallas fused training-iteration kernels (ops/train_kernel.py):
        # "auto" = on when running on TPU and the config is covered
        # (geo-only heads, 1 hidden layer); True/False force it
        self.use_pallas_train = "auto"
        # training-scan unroll: 0 = auto (5 on the Pallas path, where the
        # per-iteration math is order-fixed inside the kernels and unrolling
        # only removes XLA loop machinery; 1 on the autodiff path, where
        # cross-iteration refusion reassociates f32 math enough to move
        # drift — PERF_TPU.md r3 ledger)
        self.train_unroll: int = 0
        # Pallas candidate-ranking kernel for the append-time kNN
        # (ops/rank_kernel.py); "auto" = on when running on TPU
        self.use_pallas_rank = "auto"
        # exact voxel-dedup group probe at append time
        # (mapper.dedup_group_probe): items sharing a probe voxel share one
        # hash-ball gather — bit-identical in-budget results; items past the
        # static budget lose their supervision for that frame (never wrong).
        # "auto" = on everywhere (pure XLA); budgets are fractions of the
        # free-space sample count / ray count (measured voxel duplication:
        # groups fit in 0.44x/0.38x items at bench/KITTI shapes — PERF_TPU.md)
        # post-downsample compaction bucket for the mapping cloud: the
        # on-device voxel-downsample keep-mask leaves the static frame width
        # untouched, so every downstream op (sampler, probes, pool append)
        # pays full frame_bucket width even when the profile's vox_down_m
        # discards most rows (KITTI: ~131k raw -> ~40k mapped at 0.08 m,
        # ref config/lidar_slam/run_kitti.yaml + dataset/slam_dataset.py:282).
        # Compacting survivors into this bucket recovers the reference's
        # effective per-frame workload.  0 = off (no compaction); survivors
        # past the bucket are dropped with their supervision.
        self.mapping_bucket: int = 0
        # fresh-surface free-space damping (ACCURACY.md seed-5 mitigation):
        # the BCE objective's free-space samples exist only on the SENSOR
        # side of a surface, which biases freshly-observed surfaces' trained
        # zero-crossings a few mm toward the sensor; when the local scene
        # keeps that bias direction coherent the online loop integrates it
        # into drift.  < 1.0 keeps only this fraction of the front free-space
        # samples of rays whose ENDPOINT lands in a low-certainty (fresh)
        # region — full pressure returns once the region is converged.
        # 1.0 = off (reference behavior, ref utils/data_sampler.py:79-87).
        # Measured and rejected on the JAX package (it cost drift,
        # PERF_TPU.md r5); the port keeps only the default: < 1.0 raises
        self.fresh_freespace_damp: float = 1.0
        self.use_probe_dedup = "auto"
        # brick-packed hash rows (models/neural_points.py MapConfig.brick):
        # pack the cells of a (2,2,1) brick into one physical hash row so the
        # append-time K-cell probe gathers ~K/4 rows at identical candidate
        # sets (integer-exact membership masking; PERF_TPU.md r5).  "auto" = on
        # everywhere; also accepts an explicit [bx,by,bz] list or false
        self.use_brick_hash = "auto"
        # group budget as a fraction of far samples.  Groups-needed measures
        # 0.38-0.49x items across bench/KITTI/square scenes, but running the
        # budget NEAR the need silently drops free-space supervision on the
        # frames that exceed it — measured square-loop drift 0.042 -> 0.112 m
        # at 0.5 vs BIT-EXACT 0.042 m at 0.75 (PERF_TPU.md r4 ledger).  Default
        # 0.75 = exactness headroom; benches may set a scene-measured value
        self.probe_dedup_budget: float = 0.75
        # endpoint (shared-ball) dedup is OFF by default: measured on v5e the
        # q=4-per-item mapback (131k rows) costs more than the probe rows it
        # saves (+6 ms vs -2; PERF_TPU.md r4); the port keeps only the
        # default: > 0 raises
        self.probe_dedup_near_budget: float = 0.0
        # city-scale spatial map sharding (parallel/spatial.py live backend):
        # >1 shards the GLOBAL neural-point SoA + voxel hash over that many
        # devices of a ("data","map") mesh; the bounded local window stays
        # replicated so tracker/training/mesher run unchanged.  PGO + elastic
        # map deformation run sharded (r5); v1 still requires
        # ba_freq_frame=0 and dp_devices=1.  Caveat (ADVICE r4
        # #4): if the
        # MERGED local window overflows n_map*local_capacity (every shard
        # simultaneously full), the overflow trim keeps members shard-major
        # rather than oldest-first as on a single device.
        self.map_shards: int = 1
        # syncing per-frame loss scalars to host costs a device round trip per
        # frame; disable for benchmarking / production runs
        self.log_loss_per_frame: bool = True

        # sharding
        self.mesh_shape: List[int] = []           # e.g. [8] for 8-way data parallel
        self.data_axis: str = "data"

        # run dir (filled by setup_experiment)
        self.run_name: str = ""

    # ------------------------------------------------------------------
    @property
    def sdf_scale(self) -> float:
        """Decoder output scale under BCE loss (reference model/decoder.py:51-54)."""
        if self.main_loss_type == "bce":
            return self.logistic_gaussian_ratio * self.sigma_sigmoid_m
        return 1.0

    @property
    def diff_travel_dist_local(self) -> float:
        return self.local_map_radius * self.local_map_travel_dist_ratio

    @property
    def max_valid_dist2(self) -> float:
        """Neighborhood validity radius^2 (reference model/neural_points.py:457)."""
        return 3.0 * ((self.num_nei_cells + 1) * self.voxel_size_m) ** 2

    @property
    def ray_sample_count(self) -> int:
        return 1 + self.surface_sample_n + self.free_front_n + self.free_behind_n

    # ------------------------------------------------------------------
    # YAML key -> attribute aliases, matching the reference loader's vocabulary
    # exactly (reference utils/config.py:327-567) so its profiles port unchanged.
    _SECTION_KEYS = {
        "setting": {
            "name": "name", "output_root": "output_root", "pc_path": "pc_path",
            "pose_path": "pose_path", "calib_path": "calib_path",
            "label_path": "label_path", "load_model": "load_model",
            "model_path": "model_path", "first_frame_ref": "first_frame_ref",
            "begin_frame": "begin_frame", "end_frame": "end_frame",
            "every_frame": "every_frame", "random_seed": "seed", "seed": "seed",
            "device": "device", "deskew": "deskew",
            "kitti_correct": "kitti_correction_on", "correct_deg": "correction_deg",
            "kitti_correction_on": "kitti_correction_on",
        },
        "process": {
            "min_range_m": "min_range", "max_range_m": "max_range",
            "min_z_m": "min_z", "max_z_m": "max_z",
            "rand_downsample": "rand_downsample", "vox_down_m": "vox_down_m",
            "rand_down_r": "rand_down_r", "adaptive_range_on": "adaptive_range_on",
            "estimate_normal": "estimate_normal", "semantic_on": "semantic_on",
            "color_map_on": "color_map_on", "color_channel": "color_channel",
            "filter_noise": "filter_noise",
        },
        "sampler": {
            "surface_sample_range_m": "surface_sample_range_m",
            "surface_sample_n": "surface_sample_n",
            "free_sample_begin_ratio": "free_sample_begin_ratio",
            "free_sample_end_dist_m": "free_sample_end_dist_m",
            "free_front_sample_n": "free_front_n",
            "free_behind_sample_n": "free_behind_n",
        },
        "neuralpoints": {
            "voxel_size_m": "voxel_size_m", "query_nn_k": "query_nn_k",
            "num_nei_cells": "num_nei_cells", "search_alpha": "search_alpha",
            "feature_dim": "feature_dim", "weighted_first": "weighted_first",
            "buffer_size": "buffer_size", "use_mid_ts": "use_mid_ts",
            "local_map_travel_dist_ratio": "local_map_travel_dist_ratio",
            "max_prune_certainty": "max_prune_certainty",
            "from_sample_points": "from_sample_points",
            "map_surface_ratio": "map_surface_ratio",
            "pos_encoding_band": "pos_encoding_band",
            "pos_encoding_gaussian": "use_gaussian_pe",
        },
        "decoder": {
            "mlp_level": "geo_mlp_level", "mlp_hidden_dim": "geo_mlp_hidden_dim",
            "freeze_after_frame": "freeze_after_frame", "mlp_bias_on": "mlp_bias_on",
        },
        "loss": {
            "main_loss_type": "main_loss_type", "sigma_sigmoid_m": "sigma_sigmoid_m",
            "loss_weight_on": "loss_weight_on", "dist_weight_scale": "dist_weight_scale",
            "behind_dropoff_on": "behind_dropoff_on",
            "ekional_loss_on": "ekional_loss_on", "weight_e": "weight_e",
            "numerical_grad_on": "numerical_grad", "grad_decimation": "gradient_decimation",
            "num_grad_step_ratio": "num_grad_step_ratio",
            "consistency_loss_on": "consistency_loss_on",
            "weight_s": "weight_s", "weight_i": "weight_i",
        },
        "continual": {
            "pool_capacity": "pool_capacity",
            "batch_size_new_sample": "bs_new_sample",
            "new_certainty_thre": "new_certainty_thre",
            "pool_filter_freq": "pool_filter_freq",
        },
        "tracker": {
            "track_on": "track_on", "photo_loss": "photometric_loss_on",
            "photo_weight": "photometric_loss_weight",
            "source_vox_down_m": "source_vox_down_m",
            "uniform_motion_on": "uniform_motion_on",
            "min_grad_norm": "reg_min_grad_norm", "max_grad_norm": "reg_max_grad_norm",
            "GM_dist": "reg_GM_dist_m", "GM_grad": "reg_GM_grad",
            "lm_lambda": "reg_lm_lambda", "iter_n": "reg_iter_n",
            "term_deg": "reg_term_thre_deg", "term_m": "reg_term_thre_m",
            "eigenvalue_check": "eigenvalue_check", "consist_wieght": "consist_wieght_on",
            "dynamic_filter_on": "dynamic_filter_on", "valid_ts": "valid_ts_in_points",
        },
        "pgo": {
            "map_context": "global_loop_on", "pgo_freq_frame": "pgo_freq",
            "context_cosdist": "context_cosdist_threshold",
            "virtual_side_count": "context_virtual_side_count",
            "min_loop_travel_ratio": "min_loop_travel_dist_ratio",
            "local_map_context": "local_map_context",
            "loop_with_feature": "loop_with_feature", "gt_loop": "use_gt_loop",
            "pgo_max_iter": "pgo_max_iter", "tran_std": "pgo_tran_std",
            "rot_std": "pgo_rot_std", "use_reg_cov": "use_reg_cov_mat",
            "merge_map": "pgo_merge_map", "context_num_candidates": "context_num_candidates",
            "loop_z_check_on": "loop_z_check_on", "with_pose_prior": "pgo_with_pose_prior",
        },
        "optimizer": {
            "iters": "iters", "init_iter_ratio": "init_iter_ratio",
            "batch_size": "bs", "learning_rate": "lr", "lr_pose": "lr_pose",
            "weight_decay": "weight_decay", "adam_eps": "adam_eps",
            "mapping_freq_frame": "mapping_freq_frame",
            "ba_freq_frame": "ba_freq_frame", "ba_local_frame": "ba_frame",
        },
        "eval": {
            "wandb_vis_on": "wandb_vis_on", "silence_log": "silence",
            "o3d_vis_on": "o3d_vis_on", "sensor_cad_path": "sensor_cad_path",
            "mesh_freq_frame": "mesh_freq_frame", "keep_local_mesh": "keep_local_mesh",
            "sdf_freq_frame": "sdfslice_freq_frame", "sdf_slice_height": "sdf_slice_height",
            "mesh_min_nn": "mesh_min_nn", "skip_top_voxel": "skip_top_voxel",
            "min_cluster_vertices": "min_cluster_vertices", "mc_res_m": "mc_res_m",
            "save_map": "save_map", "save_merged_pc": "save_merged_pc",
            "save_mesh": "save_mesh",
        },
        "tpu": {k: k for k in (
            "map_capacity", "local_map_capacity", "frame_bucket", "source_bucket",
            "insert_bucket", "downsample_hash_size", "mesh_query_bucket",
            "mesh_shape", "buffer_size", "dp_devices",
            "far_num_nei_cells", "far_search_alpha", "use_pallas_train",
            "train_unroll", "use_pallas_rank", "use_probe_dedup",
            "probe_dedup_budget", "probe_dedup_near_budget", "map_shards",
            "mapping_bucket", "use_brick_hash", "fresh_freespace_damp")},
        # ROS node knobs (ref utils/config.py:321-324; the reference reads
        # them as code defaults too, but make them YAML-settable here)
        "ros": {k: k for k in (
            "publish_np_map", "republish_raw_input", "timeout_duration_s")},
    }

    def load(self, config_file: str) -> "Config":
        """Load a YAML profile using the reference's section layout + key names
        (reference utils/config.py:327-586)."""
        with open(os.path.abspath(config_file)) as f:
            args = yaml.safe_load(f) or {}

        for section, keymap in self._SECTION_KEYS.items():
            payload = args.get(section) or {}
            for yaml_key, attr in keymap.items():
                if yaml_key in payload:
                    setattr(self, attr, payload[yaml_key])
                elif attr in payload:  # also accept attribute names directly
                    setattr(self, attr, payload[attr])

        if "pgo" in args:
            self.pgo_on = True
        if self.color_map_on:
            self.color_on = True
            if self.color_channel == 0:
                self.color_channel = 3
        if "eval" in args and "mc_res_m" not in (args.get("eval") or {}):
            self.mc_res_m = self.voxel_size_m
        for intattr in ("pool_capacity", "buffer_size", "bs", "bs_new_sample"):
            setattr(self, intattr, int(float(getattr(self, intattr))))
        # YAML 1.1 reads an exponent without a decimal point ("1e-3", as in
        # run_replica.yaml's tracker terms) as a string: read it as the float
        # the key's default is
        floats = vars(type(self)())
        for name, val in vars(self).items():
            if isinstance(val, str) and isinstance(floats.get(name), float):
                setattr(self, name, float(val))

        self._derive()
        return self

    def _derive(self) -> None:
        """Derived/coupled parameters (reference utils/config.py:568-586)."""
        self.infer_bs = self.bs * 64
        self.consistency_count = int(self.bs / 4)
        self.window_radius = max(self.max_range, 6.0)
        self.local_map_radius = self.max_range + 2.0
        if self.local_map_context:
            self.context_cosdist_threshold += 0.08
            if self.loop_with_feature:
                self.context_cosdist_threshold += 0.08
        else:
            self.loop_with_feature = False
        # keep buckets sane w.r.t. the chosen ranges
        self.pool_capacity = int(self.pool_capacity)
        self.buffer_size = int(self.buffer_size)
        if self.mapping_freq_frame != 1:
            # every shipped reference profile uses 1; the fused per-frame
            # update+train program has no skip-training variant yet.  Printed
            # unconditionally (one-time config notice): every shipped profile
            # sets silence=True, which used to swallow it (ADVICE r3)
            print("[config] mapping_freq_frame != 1 is treated as 1 "
                  "(training runs every frame)")
