#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pin_slam_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # what the checks run: build, the paths, meshes, CLI, kernels

1. Builds every CUDA kernel from ``pin_slam_torch/csrc`` (one nvcc per
   source, in parallel) into ``build/kernels``.
2. Path A: the default profile (weighted_first) at the bench capacities
   (map 2^18, local 2^16, pool 2^21, 2^15 rays/frame), 12 frames of the
   synthetic corridor world, PGO off.
3. Path B: ``config/lidar_slam/run_kitti.yaml`` (per-neighbour decoding,
   vox_down 0.08, 8 samples/ray) at the KITTI capacities (map 2^22,
   local 2^18, 2^17 rays, mapping bucket 2^16, pool 2^23), 8 frames, PGO off.
4. Path C: ``run_kitti.yaml`` as shipped (per-neighbour decoding, global
   scan-context loop detection) with PGO on, at path B's capacities, over
   every frame of the square-loop scene of the JAX package's loop-closure
   test (seed 7, side 8 m, step 0.8 m), with that test's overrides
   (pgo_freq 4, min_loop_travel_dist_ratio 1, reg_iter_n 100, valid-ratio
   gates 0.1 / 0.08).  It must add a loop factor, apply PGO, and keep the
   pose-graph trajectory within the test's gates (endpoint < 0.3 m and no
   worse than odometry + 0.5 m, position RMSE < 0.15 m).
   Each path runs with every kernel launch counter at 0 just before it and
   read just after; every kernel must have launched in it (the per-cell
   rank kernel must not: the brick layout probes and ranks in the fused
   ``rank_brick`` kernel, and never through its plain twin), losses must be
   finite, poses must stay near the scene's ground truth (A and B: every
   frame after the first must register).
5. Path D: ``config/lidar_slam/run_ncd_128.yaml`` as shipped (deskew,
   adaptive range, mid timestamps, per-neighbour decoding, bundle
   adjustment every 20 frames over a 50-frame window, PGO with map context)
   at its own capacities (map 2^21, local 2^18, frame bucket 2^17, pool
   10^7) with path C's square-loop overrides, through ``SlamSystem.run()``
   over all 96 frames of the square-loop scene re-rendered as rolling
   128-beam sweeps and written under build/ in the NCD-128 layout (PLY with
   per-point time), reached by ``set_dataset_path(cfg, "ncd128", seq)``.
   Bundle adjustment runs at frames 39, 59 and 79.  Gates: every frame
   after the first registers; max position error < 0.5 m; each BA's loss
   finite and its last value not above its first; the first BA, rerun from
   a snapshot of its inputs, gives bit-identical features and xi; the row
   gather and scatter launch 60 times in each BA; from frame 2 on, the
   deskewed points' mean distance to their true mid-sweep coordinates is at
   most half the raw points'; every kernel launched.
6. Path E: ``config/rgbd_slam/run_replica.yaml`` as shipped (colour head,
   photometric tracking, BA every 20 frames, save_map and save_mesh; map
   2^22, local 2^19, frame bucket 2^17, source bucket 2^13, pool 2e7, bs
   16384 x 20), a copy changed only in ``pc_path``, ``pose_path`` and
   ``output_root``, through ``pin_slam_torch.cli.main`` in process, on 41
   frames of a painted room (walls, boxes, pillars) rendered by a
   1200 x 680 camera with Replica's intrinsics (depth in 16 bits at
   6553.5, colour in 8), back-projected at stride 2 by
   ``converters.backproject_depth`` and written under build/ in the
   Replica layout ``converters.convert_replica`` writes.  Gates: every
   frame registers; max position error < 0.2 m; the colours regressed at
   the map's points with at least 6 neighbours within 0.2 (mean absolute
   error) of the painted field; the written mesh non-empty, its vertex
   colours finite, in [0, 1] and within 0.2 of the field; ``pin_map.npz``
   reloads with its colour features and colour decoder; every frame's
   photometric rows hold points; the BA at frame 39 finite and not
   rising; one training call, rerun from a snapshot, bit-identical in the
   geometry and colour features and both decoders; every kernel launched,
   the colour gather and scatter once an iteration.
7. ``cli_kitti``: ``pin_slam_torch.cli.main`` in-process on 8 corridor
   frames written under build/ in the KITTI layout (camera-frame poses,
   calib.txt), with a copy of ``run_kitti.yaml`` changed only in
   ``pc_path`` and ``output_root``.  Gates: return code 0, 8 frames in
   summary.json, a run()'s artifacts, the ground truth through calib.txt
   within 1e-9 m of the scene's, finite poses, every kernel launched.
8. Kernel phases: every kernel is run on the card on the inputs the paths
   gave it (captured in one extra, untimed frame after each path's timed
   frames, per path and shape), held against its plain PyTorch version
   (integers, ranks and gathers exact; floats part by part within the stated
   tolerances; the scatter, in its zero-base form that the path calls and
   in its table form, with the bits of the in-order sum
   ``rows.scatter_add_rows_ordered`` and within a float64 bound; the fused
   rank, the scatter, the train and the eikonal kernel also bit-identical
   across two launches) and timed beside its plain
   version and the one PyTorch call that computes the same function where
   there is one, each two ways:
   ``ms``, CUDA events around one launch on an idle card (median of 25; the
   host's launch path included), and ``device_ms``, many launches queued
   behind ``torch.cuda._sleep`` between two events (the device alone).  The
   train and eikonal kernels also at k = 8 on random inputs, the row kernels
   also at the Pallas experiment's own shape, the per-cell rank kernel
   (on no path) at path B's near shape with K = 81 on random rows.
   The row gather and scatter also at bundle adjustment's shapes on path D
   (its first call's inputs): the feature gather forward and the in-order
   scatter of its gradient; on path E also the colour labels' and colour
   features' gathers and the colour gradient's scatter (``pathE-*``).
9. Edge cases on random inputs: the train kernel at B in {1, 37, 16384}
   and the eikonal kernel at n in {1, 37, 1638}, each x k in {1, 6, 8, 16}
   x offset width VD in {3, 15, 27, 35, 64} (the VD = 3 build and the
   general form) x both modes on dyadic inputs (float64 check, two launches
   bit-identical),
   the row gather at C in {1, 9, 24, 42} x M in {0, 1, 98304} on aligned
   and misaligned tables and on one of more than 2^31 floats (bit-exact),
   the fused rank kernel at G in {0, 1, 37} x n in {1, 4, 5} x k in
   {1, 6, 16} with both paths' candidate counts (Kc 64, 128) on a colliding
   random table, with negative probes and probes at 1e6, and the per-cell
   one at the same G, n, k with K 33 and 81 (exact, two launches
   bit-identical), both scatter forms at C in {1, 8, 9, 24} x N in
   {1, 33, 4099} x M in {0, 1, 5000}, with and without a skipped row (the
   in-order sum's bits, two launches bit-identical).

10. End of run, after paths A and C (each after its capture frame):
   ``SlamSystem.save_artifacts`` with save_map, save_mesh and save_merged_pc
   on, into a temporary run directory under ``build/``, then
   ``write_results``.  The ``mesh_A`` / ``mesh_C`` line reports the map's
   count before and after ``finalize_map`` and its time, the chunks and grid
   points of the whole-map mesher and its grid query's time (synchronised)
   and points/s, each chunk's extraction time in numpy and, where the host
   extension builds from ``native/pin_native.cpp`` into ``build/native``,
   natively (else ``"native": "unavailable"``), the mesh's size, F-score and
   Chamfer-L1 against the scene's surfaces, the trajectory's ATE and peak
   memory.  Gates: the grid query runs on the card; a non-empty mesh of
   finite vertices whose xy extent covers 0.8 of the map's; ``pin_map.npz``
   reloads to the finalised map and decoder; every artifact is written;
   no chunk's view overflows the local capacity; native and numpy
   extraction agree within tests/test_native.py's bounds.  On path C the
   mesher runs once more with views of 2^13 rows (its ``multi_chunk``
   entry), so that the map needs several chunks and views: gated on more
   than one chunk, no view overflowing, the xy extent, and a Chamfer
   distance to the one-chunk mesh of at most MULTI_CHAMFER_FRAC x
   mc_res_m; and a whole-map view of 2^13 rows, which overflows (the oldest
   kept), must equal the same view built on the CPU.

11. Path F: the semantic LiDAR profile.  A copy of ``run_kitti.yaml``
   changed in its paths (``pc_path``, ``label_path``, ``pose_path``,
   ``calib_path``, ``output_root``), in semantic_on, dynamic_filter_on
   and estimate_normal (filter_moving_object is True by default), and to
   path B's KITTI capacities (map 2^22, local 2^18 and 2^17 rays as the
   profile ships them; pool 2^23 and a 2^16 mapping bucket set;
   per-neighbour decoding, bs 16384), through
   ``pin_slam_torch.cli.main`` in process on 16 sweeps of the labelled
   corridor (``synthetic.labelled_corridor_scans``: road, buildings,
   poles, a walking person with a moving class, a car labelled static
   that drives through observed free space) written under build/ in the
   SemanticKITTI layout.  The semantic head trains by the autograd loop.
   Gates: every frame after the first registers, max position error
   < 0.5 m; the pool's classes within {0} and the scene's classes, never
   the person's (6); the semantic head right at >= 0.8 of 256 observed
   road points and of 256 building points; >= 0.8 of the mesh's vertices
   carry the class of the nearest scene surface; the dynamic filter drops
   at least ``F_GATE_CAR_DROP`` of the car's points from its entry on and
   keeps >= 0.99 of the static surfaces' points; >= 0.5 of every frame's
   valid source points carry a valid normal; ``pin_map.npz`` reloads with
   its semantic head, which decodes the same classes; frame 5's training
   call rerun from a snapshot bit-identical; the rank, gather and scatter
   kernels launched and the training kernels not.  Its kernel rows:
   ``rank_brick[pathF-far|near]``, ``gather[pathF-pool|feat]``,
   ``scatter[pathF-sem]`` (the autograd loop's feature gradient).
12. ``train_general``: path B's profile and capacities on 4 corridor frames
   with ``geo_mlp_level: 2`` and ``mlp_bias_on: False`` (the autograd
   loop).  Gates: every frame registers, position error < 0.5 m, finite
   losses, the first training call's loss falling, no training kernel.
13. Path G: ``config/lidar_slam/run_livox.yaml`` as shipped (k = 8,
   per-neighbour decoding, pool 2e7, map 2^21, local 2^18, frame bucket
   2^16, BA off, ``mapping_freq_frame: 2``, which both packages read and
   train every frame anyway), a copy changed only in ``pc_path`` and
   ``output_root``, through ``pin_slam_torch.cli.main`` in process on 14
   sweeps of the labelled corridor's static surfaces seen through a Livox
   Avia's 70.4 x 77.2 degree field of view (60,000 points a sweep), written
   as binary PCD under build/.  Gates: every frame after the first
   registers; max position error < 0.5 m against the scene's trajectory
   relative to its first pose (the profile gives no poses); the pool's rows
   hold 8 integral neighbour ids and, on rows with a neighbour, 8 weights
   summing to 1 (1e-5); the training kernels launched at k = 8.  Kernel
   rows ``rank_brick[pathG-far|near]``, ``train_iter[pathG]``,
   ``eikonal[pathG]``, ``gather[pathG-pool|feat]``, ``scatter[pathG]``.
14. Path H: path B with ``pos_encoding_band: 4`` (NeRF, VD = 27; pool rows
   of 210 floats), 8 frames.  Path B's gates, and the tracker takes the
   autograd path (no closed-form evaluation).  Its training kernels run
   their general form at VD = 27.  ``pe_gaussian``: path A with
   ``pos_encoding_gaussian: True`` and 16 bands (VD = 35) at
   ``pos_encoding_freq: 1`` (at the default 200 neither package registers
   a frame of the corridor; at 1 both do, tests/test_torch_slam_configs.py),
   4 frames, with path A's gates; its kernel rows are at VD = 35.
   ``wide_B``: path B with ``feature_dim: 16`` and ``mlp_hidden_dim: 128``
   (feature rows of 17 floats, a (2^22 + 1) x 17 feature table, ~285 MB),
   6 frames; ``pe_nerf11``: path H with ``pos_encoding_band: 11`` (VD =
   69, the first offset width past the width classes), 4 frames.  B's
   gates (and H's tracker gate on pe_nerf11), and both training kernels run
   their tiled general form (``gtl`` in csrc/train_common.cuh) on every
   iteration: no plain twin is called on any path.  The general forms'
   edge sweep adds ``width_edges``: the tiled form at (F, H, VD) in
   ``EDGE_WIDTHS`` up to the widest ``kernels_take`` accepts (64, 256,
   195), k 1 / 6 / 8 / 16, both modes, at rows no multiple of any tile.
15. ``exact_A`` and ``exact_B_ln``: ``PIN_SLAM_EXACT_KNN=1`` on path A's
   profile (weighted_first) and on path B's with ``layer_norm_on: True``
   (per neighbour), 4 frames each, training with ``mapper.mapping_loop``
   (a fresh kNN per batch).  Gates: every frame after the first registers,
   position error < 0.5 m, finite losses, frame 2's training call rerun
   from a snapshot bit-identical, no training-kernel launch, a gather and a
   scatter launch at least once an iteration.  Kernel rows
   ``gather[exact_*-pool|feat]``, ``scatter[exact_*]`` (the feature
   gradient) and ``scatter[exact_*-cert]`` (the certainty sum, one column,
   some 1.6 M terms on B's shapes), from the last frame's inputs.
16. Path I: ``config/lidar_slam/run_ros_general.yaml`` as shipped (a copy
   changed only in ``output_root``: map 2^22, local 2^18, frame bucket 2^17,
   source bucket 2^14, bs 10000, pool 2e7, voxel 0.4 m, range 2.5-80 m,
   PGO bookkeeping on) through ``pin_slam_torch.ros.PinSlamRosNode`` under
   chip_smoke's own fakes of ``rospy``, ``tf2_ros``,
   ``sensor_msgs.point_cloud2`` and the message modules (``ros_fakes``):
   16 sweeps of path F's corridor without its movers (~98 k points each)
   fed to ``frame_callback`` as point-cloud messages, each timed with its
   conversion.  Gates: every pose finite, position error < 0.5 m against
   the scene's trajectory relative to its first pose (the profile gives no
   poses); per frame one odometry message, one TF, the path one pose
   longer, a ``~map/neural_points`` cloud of ceil(count / down_rate)
   points (the ladder's rate), non-empty ``~frame/mapping`` and (from frame
   1) ``~frame/registration`` clouds; the ``save_results`` service writes
   the pose files, ``save_mesh`` a non-empty finite ``mesh/mesh.ply``,
   ``finish()`` a ``pin_map.npz`` that reloads on the card.  One more
   sweep is the capture frame of the rows ``rank_brick[pathI-far|near]``,
   ``train_iter[pathI]``, ``eikonal[pathI]``, ``gather[pathI-pool|feat]``,
   ``scatter[pathI]``.
17. ``Egen``: 8 frames of path E's room with ``geo_mlp_level: 2`` (a copy of
   ``run_replica.yaml`` changed in its paths and that key) through
   ``cli.main``: the colour head beside an SDF decoder the kernels do not
   take, both in the autograd loop.  Gates: every frame registers, error
   < 0.2 m, colour MAE < 0.2 at map points with >= 6 neighbours, no
   train_iter or eikonal launch, the feature and colour rows' gathers and
   scatters once an iteration, the colour labels' gather once a call, frame
   5's training call rerun from a snapshot bit-identical.  Rows
   ``gather[Egen-feat|color]``, ``scatter[Egen|Egen-color]``.
18. ``live_C``: path C's whole square loop with ``o3d_vis_on``,
   ``mesh_freq_frame`` and ``sdfslice_freq_frame`` 32, ``pause_at_loop`` in
   ``control.json`` and ``utils/viewer_server.py`` serving the run
   directory on 127.0.0.1; a watcher thread POSTs ``mesh_now`` once, an
   ``mc_res_m`` retune (5 / 8 of the profile's) once, and resumes the run
   the loop hook paused after holding it ``LIVE_HOLD_S``.  Gates: C's pose
   and closure gates; in-run meshes exactly at the cadence (32, 64), the
   closure frames and one ``mesh_now`` frame, each non-empty and finite; the
   first mesh after the retune on the new grid (``grid_share``); SDF slices
   at 0, 32, 64; ``viewer.html`` and ``viewer_data.js`` with the last mesh
   frame in their meta; the run held at the frame after the closure for at
   least ``LIVE_HOLD_S`` with the viewer's meta paused, then resumed; no
   pipeline warning (``_warned_keys`` empty); every kernel launched.
19. ``vis_pin_map``: ``pin_slam_torch.vis_pin_map.main`` in process on
   live_C's saved map, on the card, at 0.2 m.  Gates: a non-empty, finite
   mesh over at least 0.8 of the map's xy extent, viewer.html written.
20. ``dp_nccl1``: a process group of world size 1 over NCCL on cuda:0,
   brought up by ``parallel.distributed.initialize()`` from torchrun's
   variables set in this process.  The data-parallel mapping loop at path
   B's widths (``run_kitti.yaml``, KITTI capacities, bs 16384 x 15, its
   collectives run) bit-identical to ``mapping_loop_cached`` on the same
   indices; the DP mesher's grid query over one chunk identical to the
   plain query; the loop's collective time.
21. ``dp_B``: path B with ``dp_devices: 2`` as two processes on cuda:0
   under gloo (``PIN_SLAM_DIST_BACKEND=gloo``; NCCL refuses two ranks on
   one GPU), started by ``parallel.launch.spawn`` with a hard timeout
   (a child's failure fails the run; the children only load the kernels
   this process built), 8 frames and a capture frame.  Gates: B's gates;
   both ranks' poses, map and decoder bit-identical; frame 5's training
   call, rerun from a snapshot, bit-identical twice and within
   tests/test_torch_parallel.py's tolerances of the one-rank loop on the
   two ranks' stitched indices (eikonal off: the two take different
   eikonal rows by construction); every kernel launched; the end-of-run
   mesh through the DP mesher non-empty and finite.  Rank 0 holds the
   training kernels, the gathers and the scatter at its per-rank shapes
   (B = 8192) to their plain twins: rows ``*[dp_B]``.  Reports frames/s
   and the all-reduce ms an iteration.
22. ``shard_C``: path C with ``map_shards: 2``, two processes on cuda:0
   under gloo.  Gates: C's closure and error gates; the shards' summed
   count within tests/test_spatial.py's tolerance of path C's; both
   ranks' poses identical; after the shards are densified, ``pin_map.npz``
   reloads to the finalised map and the mesh covers >= 0.8 of its xy
   extent.  Rank 0's rank kernel rows ``rank_brick[shard_C-far|near]``.
   A real NCCL ring of two or more GPUs does not run here (one card).
23. ``pool_pass``: the replay pool's pass after a pose change
   (``ops/pool_kernel.py``) at ``kitti_hdl64.loop``'s and
   ``ncd_os0_128.quad``'s pools, each after ``POOL_SETUP_FRAMES`` of the
   cell's own frames through the program, with the pose books and the map
   deformed by per-frame corrections; the kernel against its plain twin (the
   parent's two calls) by column group (``pool_check``, ``POOL_TOL``), both
   timed, the bound at the pool's fill: rows ``pool_pass[<cell>]``.
   ``pool_edges``: every k 1..8 in both layouts on random pools.

Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and last ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, on any failure or without a GPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # float32 outside the tensor cores
TIMED = 25
DEVICE_REPS = 64                  # calls per device-time batch (fewer if the queue fills)
PLAIN_REPS = 8                    # the same for the plain versions (dozens of launches a call)
SLEEP_CYCLES_PER_S = 2.0e9        # above the H100's top SM clock: a sleep is never too short

# stated tolerances of the float comparisons on the card.  A training
# kernel's outputs are held, part by part, against its plain twin evaluated
# in float64 on the same inputs (T); each part has its own scale: the loss,
# the feature gradients dfeats[..., :F], the certainty column dfeats[..., F]
# (w, or the sum of the six stencil weights) and each decoder-gradient leaf
# (dW1, db1, dW2, db2).  A part passes if max|kernel - T| is within its
# tolerance times max|T| (TOL_REL; TOL_CERT for the certainty column).  A
# decoder leaf may instead be within DEC_ULPS float32 ulps (2^-23) of the
# largest |decoder gradient|: the leaves are batch sums of the same per-row
# output gradients, and where these cancel the leaf's own value is rounding
# noise of that size.  The eikonal's db2 is (nearly) zero in exact arithmetic (each
# central difference subtracts the output bias from itself); on an H100 its
# error measures up to about 5e-10 on path B against decoder gradients of
# about 1.2e-3, i.e. about 3 ulps of them.
TOL_REL = 1e-4
TOL_CERT = 1e-6
DEC_ULPS = 64
# the row scatter sums each destination row's n contributions in float32, in
# order: |sum - exact| <= n * 2^-24 * (|table| + sum |values|) (the standard
# bound for recursive summation, gamma_n ~ n u); each element is held to
# that bound against the float64 sum.
SCATTER_ULP = 2.0 ** -24


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: n/a"


# ----------------------------------------------------------------------
# capture of the kernels' inputs on the main path
# ----------------------------------------------------------------------


class Capture:
    """Wraps the main path's kernel wrappers.  While a path's timed frames run
    it only tallies launches per path and shape; while ``capturing`` (one
    extra, untimed frame after them) it keeps a clone of each kernel's inputs
    per path and shape instead; while ``store`` it does both (path D keeps
    the inputs of its last frame and of its first bundle adjustment so).
    The row kernels' launches made inside bundle adjustment (``in_ba``) are
    kept apart, as kind ``ba``; while ``slim`` (the exact-kNN loop, whose
    feature table has no certainty column) the 8-column rows are the
    feature rows and their gradient.  The one-column scatter is the exact
    loop's certainty sum, kind ``cert``.  It also counts calls of the fused
    rank kernel's plain twin and of the training kernels' plain twins, which
    the main path on the card must not make.  ``feat_c`` is the path's
    feature-row width, F + 1."""

    def __init__(self):
        from pin_slam_torch.ops import rank_kernel, rows, train_kernel

        self.rk, self.tk, self.rows = rank_kernel, train_kernel, rows
        self.orig = (rank_kernel.probe_rank_brick, train_kernel.train_iter,
                     train_kernel.eikonal_iter, rows.gather_rows, rows.scatter_sum_rows,
                     rank_kernel.probe_rank_brick_plain, rows.scatter_plans,
                     train_kernel.train_iter_plain, train_kernel.eikonal_iter_plain)
        self.path = None
        self.capturing = False
        self.store = False
        self.in_ba = False
        self.slim = False
        self.inputs = {}
        self.tally = {}
        self.rank_calls = 0
        self.plain_rank_calls = 0
        self.plain_train_calls = 0
        self.feat_c = 9                   # the feature rows' columns: F + 1
        self.twin = None                  # the tracker's kernel-against-twin replays (TrackTwin)

    def _keep(self, key, args, kwargs):
        import torch

        def clone(a):
            if isinstance(a, torch.Tensor):
                return a.clone()
            if isinstance(a, tuple) and hasattr(a, "_fields"):       # a ScatterPlan
                return type(a)(*(clone(x) for x in a))
            return a

        if self.capturing or self.store:
            self.inputs[key] = ([clone(a) for a in args],
                                {k: clone(v) for k, v in kwargs.items()})
        if not self.capturing:
            self.tally[key] = self.tally.get(key, 0) + 1

    def install(self):
        (probe_rank_brick, train_iter, eikonal_iter, gather_rows, scatter_sum_rows,
         rank_plain, scatter_plans, train_plain, eik_plain) = self.orig

        def rank(*a, **kw):
            # every frame probes the shared endpoint balls first, then the
            # free-space samples (pipeline._frame_update -> append_knn)
            kind = "near" if self.rank_calls % 2 == 0 else "far"
            self.rank_calls += 1
            self._keep((self.path, "rank_brick", kind), a, kw)
            return probe_rank_brick(*a, **kw)

        def plain(*a, **kw):
            self.plain_rank_calls += 1
            return rank_plain(*a, **kw)

        def train(*a, **kw):
            self._keep((self.path, "train_iter", "main"), a, kw)
            return train_iter(*a, **kw)

        def train_twin(*a, **kw):
            self.plain_train_calls += 1
            return train_plain(*a, **kw)

        def eik_twin(*a, **kw):
            self.plain_train_calls += 1
            return eik_plain(*a, **kw)

        def eik(*a, **kw):
            self._keep((self.path, "eikonal", "main"), a, kw)
            return eikonal_iter(*a, **kw)

        def gather(*a, **kw):
            # the pool rows (and with a colour head the colour labels, C = 3)
            # once per training call, the feature rows (F + 1 = 9 columns)
            # and the colour feature rows (F = 8) once per iteration; bundle
            # adjustment's feature rows (F = 8) once per iteration; the exact
            # loop's pool rows once per call, its feature rows (F = 8) once
            # per iteration; the feature rows are ``feat_c`` = F + 1 wide
            C = a[0].shape[1]
            kind = ("ba" if self.in_ba else "feat" if self.slim and C == 8
                    else {self.feat_c: "feat", 8: "color", 3: "label"}.get(C, "pool"))
            self._keep((self.path, "gather", kind), a, kw)
            return gather_rows(*a, **kw)

        def scatter(*a, **kw):
            # the training loop's scatter into a zero table, once per
            # iteration (the colour features' gradient, 8 columns, a second
            # one); bundle adjustment's feature gradient, once per iteration;
            # the exact loop's feature gradient (8 columns) once per
            # iteration and its certainty sum (1 column) once per call
            C = a[2].shape[1]
            kind = ("ba" if self.in_ba else "cert" if C == 1
                    else "color" if C == 8 and not self.slim else "main")
            self._keep((self.path, "scatter", kind), a, kw)
            return scatter_sum_rows(*a, **kw)

        def plans(*a, **kw):
            # every iteration's scatter plan, once per training call; one
            # plan per bundle-adjustment iteration; the exact loop's
            # certainty sum builds its own (one row of indices)
            kind = ("ba" if self.in_ba else "cert" if self.slim and a[0].dim() == 1
                    else "frame")
            self._keep((self.path, "plans", kind), a, kw)
            return scatter_plans(*a, **kw)

        (self.rk.probe_rank_brick, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_sum_rows, self.rk.probe_rank_brick_plain,
         self.rows.scatter_plans, self.tk.train_iter_plain, self.tk.eikonal_iter_plain) = (
            rank, train, eik, gather, scatter, plain, plans, train_twin, eik_twin)

    def uninstall(self):
        (self.rk.probe_rank_brick, self.tk.train_iter, self.tk.eikonal_iter,
         self.rows.gather_rows, self.rows.scatter_sum_rows, self.rk.probe_rank_brick_plain,
         self.rows.scatter_plans, self.tk.train_iter_plain, self.tk.eikonal_iter_plain) = self.orig


# ----------------------------------------------------------------------
# main-path runs
# ----------------------------------------------------------------------


# the main-path configurations: A and B are the JAX package's bench.py
# passes (PGO off); C is the loop-closure slice (run_kitti.yaml with PGO on)
PATHS = {
    "A": dict(profile=None, caps=(1 << 18, 1 << 16, 1 << 21, 1 << 21), n_rays=1 << 15,
              n_frames=12, mapping_bucket=0, dedup_budget=0.625, mesh=True),
    "B": dict(profile="config/lidar_slam/run_kitti.yaml",
              caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 17,
              n_frames=8, mapping_bucket=1 << 16, dedup_budget=0.5),
    "C": dict(profile="config/lidar_slam/run_kitti.yaml",
              caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 14,
              n_frames=None, mapping_bucket=0, dedup_budget=0.5, pgo=True, mesh=True,
              multi_chunk_L=1 << 13),
    # positional encoding: B with NeRF bands 4 (VD 27, 210-float pool rows),
    # and A with Gaussian Fourier features of 16 bands (VD 35) at N(0, 1) cycles a metre
    "H": dict(profile="config/lidar_slam/run_kitti.yaml",
              caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 17,
              n_frames=8, mapping_bucket=1 << 16, dedup_budget=0.5,
              over=dict(pos_encoding_band=4)),
    "pe_gaussian": dict(profile=None, caps=(1 << 18, 1 << 16, 1 << 21, 1 << 21), n_rays=1 << 15,
                        n_frames=4, mapping_bucket=0, dedup_budget=0.625,
                        over=dict(pos_encoding_band=16, use_gaussian_pe=True,
                                  pos_encoding_freq=1)),
    # the training kernels' tiled form: B with a wider decoder (F 16, H 128),
    # and H with NeRF band 11 (VD 69, past the width classes)
    "wide_B": dict(profile="config/lidar_slam/run_kitti.yaml",
                   caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 17,
                   n_frames=6, mapping_bucket=1 << 16, dedup_budget=0.5, form="tiled",
                   over=dict(feature_dim=16, geo_mlp_hidden_dim=128)),
    "pe_nerf11": dict(profile="config/lidar_slam/run_kitti.yaml",
                      caps=(1 << 22, 1 << 18, 1 << 23, 1 << 23), n_rays=1 << 17,
                      n_frames=4, mapping_bucket=1 << 16, dedup_budget=0.5, form="tiled",
                      over=dict(pos_encoding_band=11)),
}
# path C's overrides: those of the JAX package's square-loop test
# (tests/test_full_slam.py), which let a loop close on an 8 m square
SQUARE_SEED, SQUARE_PGO_FREQ = 7, 4


def make_path(name, n_frames=None, over=None):
    """(SlamSystem on the GPU, frames, ground-truth positions) of a path;
    ``over`` sets configuration keys before the system is built."""
    import torch

    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame, SLAMDataset
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    p = PATHS[name]
    n_rays = p["n_rays"]
    cfg = Config()
    if p["profile"]:
        cfg.load(os.path.join(ROOT, p["profile"]))
        cfg.pc_path = cfg.pose_path = cfg.calib_path = ""
    cfg.pgo_on = p.get("pgo", False)
    cfg.o3d_vis_on = False
    cfg.silence = True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity, cfg.buffer_size, cfg.pool_capacity = p["caps"]
    cfg.downsample_hash_size = max(1 << 19, cfg.buffer_size >> 2)
    cfg.frame_bucket = n_rays
    cfg.mapping_bucket = p["mapping_bucket"]
    cfg.probe_dedup_budget = p["dedup_budget"]
    dataset = None
    if cfg.pgo_on:
        cfg.pgo_freq = SQUARE_PGO_FREQ
        cfg.min_loop_travel_dist_ratio = 1.0
        cfg.reg_iter_n = 100
        cfg.kitti_correction_on = False    # the scene is synthetic, not KITTI's raw scans
    for k, v in {**p.get("over", {}), **(over or {})}.items():
        setattr(cfg, k, v)
    cfg._derive()

    if cfg.pgo_on:
        scans, gt_poses = syn.make_square_scene(np.random.default_rng(SQUARE_SEED))
        dataset = SLAMDataset(cfg, scans=scans, gt_poses=gt_poses)
        frames = [dataset.preprocess_frame(i) for i in range(len(scans))]
        gt = [T[:3, 3] for T in gt_poses]
    else:
        world = syn.make_world(np.random.default_rng(0))
        rng = np.random.default_rng(0)
        frames, gt = [], []
        for i in range(n_frames or p["n_frames"]):
            R, t = syn.sensor_pose(i)
            pts = syn.lidar_scan(rng, world, t, R, n_rays,
                                 n_az=1800 if n_rays > (1 << 16) else 900,
                                 n_el=128 if n_rays > (1 << 16) else 96)
            arr, valid = pad_to(pts, n_rays)
            frames.append(Frame(arr, valid, pts.shape[0]))
            gt.append(t)

    torch.cuda.reset_peak_memory_stats()
    system = SlamSystem(cfg, dataset=dataset, sync_stages=True)
    # synthetic dense-clutter scenes leave a smaller gate-passing fraction
    # than real LiDAR (the JAX package's bench and square-loop test make the
    # same adjustment)
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    system.tc_loop = dataclasses.replace(system.tc_loop, min_valid_ratio=0.08)
    return system, frames, gt


def _stage_ms(stage):
    keys = ("odometry", "map_update", "training", "pgo")
    if len(stage) == 0:
        return None
    return {k: float(stage[:, i + 1].mean() * 1e3) for i, k in enumerate(keys)}


def run_path(name, cap, mesh=False):
    """One path's timed frames, its capture frame, and with ``mesh`` (paths
    marked so) the end-of-run phase on its final map."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp

    from pin_slam_torch.slam import tracker as trk
    from pin_slam_torch.slam import tracker_grad as tg

    p = PATHS[name]
    pgo = p.get("pgo", False)
    if pgo:
        # every frame of the sequence is timed; the capture frame re-runs the last scan
        system, frames, gt = make_path(name)
        capture_frame = frames[-1]
    else:
        # the last frame is not timed: it only captures the kernels' inputs
        system, frames, gt = make_path(name, p["n_frames"] + 1)
        frames, capture_frame = frames[:-1], frames[-1]
    cfg = system.config
    n_rays, n_frames, mapping_bucket = p["n_rays"], len(frames), p["mapping_bucket"]
    cap.path = name
    cap.plain_rank_calls = 0
    cap.plain_train_calls = 0
    cap.feat_c = cfg.feature_dim + 1
    _cuda.reset_counts()
    infos, times = [], []
    queries = {"cached": 0, "autograd": 0}        # the tracker's SDF evaluations by path
    orig_q = (tg.sdf_value_and_grad_cached, trk._autograd_sdf)

    def q_cached(*a, **kw):
        queries["cached"] += 1
        return orig_q[0](*a, **kw)

    def q_auto(*a, **kw):
        queries["autograd"] += 1
        return orig_q[1](*a, **kw)

    tg.sdf_value_and_grad_cached, trk._autograd_sdf = q_cached, q_auto
    try:
        for fr in frames:
            replay0 = cap.twin.replay_s if cap.twin else 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infos.append(system.process_frame(fr))
            torch.cuda.synchronize()
            # the tracker's twin replays (TrackTwin) are not the frame's
            times.append(time.perf_counter() - t0
                         - ((cap.twin.replay_s if cap.twin else 0.0) - replay0))
    finally:
        tg.sdf_value_and_grad_cached, trk._autograd_sdf = orig_q
    counts = dict(_cuda.COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ds = system.dataset
    poses = np.stack(ds.pgo_poses if pgo else ds.odom_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    if pgo:
        odom = np.stack(ds.odom_poses)
        end_err_odom = float(np.linalg.norm(odom[-1, :3, 3] - gt[len(odom) - 1]))
        loop_edges = [(e.i, e.j) for e in system.pgm.edges if abs(e.j - e.i) > 1]
        after_pgo = system.after_pgo
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_ref = time.perf_counter()
        mp.pool_refresh_cache(system.pool, system.state.attr_rows, system.mc, system.mc.pos_encode)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t_ref) * 1e3
        refresh_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    cap.capturing = True
    system.process_frame(capture_frame)
    torch.cuda.synchronize()
    cap.capturing = False
    cap.path = None
    cap.feat_c = 9
    widths = (cfg.feature_dim, cfg.geo_mlp_hidden_dim, system.mcfg.vec_dim)

    stage = np.asarray(system.stage_times[1:n_frames])
    res = {
        "phase": f"path_{name}", "profile": p["profile"] or "default (weighted_first)",
        "weighted_first": cfg.weighted_first, "frames": n_frames, "rays_per_frame": n_rays,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "pool": cfg.pool_capacity, "mapping_bucket": mapping_bucket},
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:])),
        "frame0_s": times[0],
        "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "reg_iters": [int(x.get("reg_iters", 0)) for x in infos[1:]],
        "max_pose_err_m": float(err.max()), "map_points": int(system.state.count),
        "local_points": int(system.lm.count), "pool_fill": int(system.pool.fill),
        "pos_encoding": {"band": cfg.pos_encoding_band, "gaussian": cfg.use_gaussian_pe,
                         "vec_dim": system.mcfg.vec_dim, "pool_dim": system.mcfg.pool_dim},
        "decoder": {"F": widths[0], "H": widths[1], "VD": widths[2],
                    "training_form": mp.train_kernel.general_form(*widths),
                    "kernel_path": system.kernel_path},
        "plain_twin_calls": cap.plain_train_calls,
        "tracker_queries": queries, "launches": counts,
        "max_memory_allocated_gb": peak_gb,
    }
    if pgo:
        closure = [i for i, x in enumerate(infos) if x.get("pgo_applied")]
        detect = [i for i in range(1, n_frames)
                  if i % cfg.pgo_freq == 0 and i not in closure]
        other = [i for i in range(1, n_frames) if i % cfg.pgo_freq != 0]
        st = np.asarray(system.stage_times[:n_frames])
        res.update({
            "stage_ms_mean": {"other_frames": _stage_ms(st[other]),
                              "detection_frames": _stage_ms(st[detect]),
                              "closure_frames": _stage_ms(st[closure])},
            "closure_frames": closure,
            "loop_candidates": [(i, x["loop_candidate"], x.get("loop_verified"))
                                for i, x in enumerate(infos) if "loop_candidate" in x],
            "loop_factors": loop_edges, "after_pgo": after_pgo,
            "end_err_pgo_m": float(err[-1]), "end_err_odom_m": end_err_odom,
            "rmse_pgo_m": float(np.sqrt(np.mean(err ** 2))),
            "pool_refresh_cache_ms": refresh_ms,
            "pool_refresh_cache_peak_gb": refresh_peak_gb,
            "pool_refresh_cache_chunk_rows": mp.REFRESH_CHUNK,
        })
    emit(res)
    if not all(x.get("loss_finite", False) for x in infos if "loss_finite" in x) \
            or not any("loss_finite" in x for x in infos):
        fail(f"path {name}: non-finite training loss")
    if res["map_points"] <= 0:
        fail(f"path {name}: empty map")
    if pgo:
        if not loop_edges:
            fail(f"path {name}: no loop factor was added")
        if not after_pgo:
            fail(f"path {name}: PGO never applied (after_pgo is False)")
        if not (res["end_err_pgo_m"] < 0.3 and res["end_err_pgo_m"] <= end_err_odom + 0.5):
            fail(f"path {name}: endpoint error {res['end_err_pgo_m']:.3f} m (odometry "
                 f"{end_err_odom:.3f} m)")
        if res["rmse_pgo_m"] >= 0.15:
            fail(f"path {name}: position RMSE {res['rmse_pgo_m']:.3f} m vs the ground truth")
        need = {k: 1 for k in counts if k != "rank"}
    else:
        if not all(res["reg_valid"]):
            fail(f"path {name}: a frame after the first did not register: {res['reg_valid']}")
        if res["max_pose_err_m"] > 0.5:
            fail(f"path {name}: pose error {res['max_pose_err_m']:.3f} m vs the scene's "
                 f"ground truth")
        iters = cfg.iters * (n_frames + cfg.init_iter_ratio - 1)
        need = {"rank_brick": n_frames, "train_iter": iters, "eikonal": iters,
                "gather": iters + n_frames, "scatter": iters}
    if cfg.pos_encoding_band > 0 and (queries["cached"] or not queries["autograd"]):
        fail(f"path {name}: with positional encoding the tracker took the cached closed-form "
             f"path ({queries})")
    for k, n in need.items():
        if counts[k] < n:
            fail(f"path {name}: kernel {k} launched {counts[k]} times, expected >= {n}")
    # the cached tracker steps through the track-step kernel; the encoded
    # (autograd) tracker never does
    if (counts["track_step"] > 0) != (cfg.pos_encoding_band == 0) \
            or counts["track_step"] < (n_frames - 1 if cfg.pos_encoding_band == 0 else 0):
        fail(f"path {name}: track_step launched {counts['track_step']} times over {n_frames} "
             f"frames (positional encoding {cfg.pos_encoding_band})")
    # the training kernels' twins never run on the card's path; the paths
    # that name a form run their training kernels in it
    if cap.plain_train_calls:
        fail(f"path {name}: the training kernels' plain twins ran {cap.plain_train_calls} "
             f"times")
    if p.get("form") and (res["decoder"]["training_form"] != p["form"]
                          or not system.kernel_path):
        fail(f"path {name}: training by {res['decoder']}, not the kernels' {p['form']} form")
    # the brick layout probes and ranks in one kernel: no per-cell ranking,
    # no plain brick gather
    if counts["rank"] or cap.plain_rank_calls:
        fail(f"path {name}: the brick probe went through the per-cell rank kernel "
             f"({counts['rank']}) or the plain brick gather ({cap.plain_rank_calls})")
    if mesh and p.get("mesh"):
        mesh_phase(name, system)
    del system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# path D: the NCD-128 profile from disk, with deskew and bundle adjustment
# ----------------------------------------------------------------------

PATH_D = dict(profile="config/lidar_slam/run_ncd_128.yaml", dataset="ncd128", seq="square",
              n_az=1024, n_el=128)
BA_FRAMES = [39, 59, 79]          # ba_freq_frame 20 past ba_frame // 2 = 25


def write_path_d_data():
    """The square-loop scene (seed 7) re-rendered as rolling 128-beam sweeps
    and written under build/ in the NCD-128 layout.  Returns (dataset root,
    the sweeps' times and true mid-sweep coordinates, the setup's seconds)."""
    import shutil

    from pin_slam_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "path_d")
    shutil.rmtree(root, ignore_errors=True)
    scans, times, truth, poses = syn.make_square_sweeps(
        np.random.default_rng(SQUARE_SEED), n_az=PATH_D["n_az"], n_el=PATH_D["n_el"],
        workers=os.cpu_count() or 1)
    syn.write_ncd_sequence(os.path.join(root, "data"), PATH_D["seq"], scans, times, poses)
    return root, truth, [s.shape[0] for s in scans], time.perf_counter() - t0


def _clone(x):
    import copy

    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x)
    return x


def _bits_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def run_path_d(cap):
    """Path D: ``run_ncd_128.yaml`` as shipped (deskew, adaptive range, mid
    timestamps, per-neighbour decoding, bundle adjustment every 20 frames,
    PGO with map context) at its own capacities, with path C's square-loop
    overrides, through ``SlamSystem.run()`` over every frame of the
    NCD-layout sequence written under build/.  Each frame is timed
    (synchronised); each bundle adjustment's loop is timed and its row-kernel
    launches counted, and the first one is rerun from a snapshot of its
    inputs (features and xi must be bit-identical); deskewing is measured
    against the sweeps' true mid-sweep coordinates."""
    import glob

    import torch

    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset import io as pio
    from pin_slam_torch.dataset.indexing import set_dataset_path
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops.transforms import deskew_points
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.pipeline import SlamSystem

    root, truth, n_points, setup_s = write_path_d_data()
    cfg = Config()
    cfg.load(os.path.join(ROOT, PATH_D["profile"]))
    cfg.pc_path = os.path.join(root, "data")
    set_dataset_path(cfg, PATH_D["dataset"], PATH_D["seq"])
    cfg.run_path = os.path.join(root, "run")
    cfg.silence = True
    cfg.pgo_freq = SQUARE_PGO_FREQ
    cfg.min_loop_travel_dist_ratio = 1.0
    cfg.reg_iter_n = 100
    cfg._derive()
    torch.cuda.reset_peak_memory_stats()
    system = SlamSystem(cfg, sync_stages=True)
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    system.tc_loop = dataclasses.replace(system.tc_loop, min_valid_ratio=0.08)
    ds = system.dataset
    n_frames = len(ds)

    rel_at, times, ba_calls = {}, [], []
    orig_pre, orig_proc, orig_ba = ds.preprocess_frame, system.process_frame, \
        mp.bundle_adjustment_loop

    def pre(i):
        rel_at[i] = ds.last_odom_tran.copy() if ds.processed_frame > 0 else None
        return orig_pre(i)

    def proc(frame):
        cap.store = system.frame_id == n_frames - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig_proc(frame)
        finally:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            cap.store = False

    def ba(*a, **kw):
        first = not ba_calls
        snap = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()}) if first else None
        torch.cuda.synchronize()
        c0 = dict(_cuda.COUNTS)
        t0 = time.perf_counter()
        cap.in_ba, cap.store = True, first
        try:
            out = orig_ba(*a, **kw)
            torch.cuda.synchronize()
        finally:
            cap.in_ba, cap.store = False, False
        ba_calls.append({"loop_ms": (time.perf_counter() - t0) * 1e3,
                         "gather_launches": _cuda.COUNTS["gather"] - c0["gather"],
                         "scatter_launches": _cuda.COUNTS["scatter"] - c0["scatter"],
                         "snap": snap, "out": (out[0].clone(), out[1].clone()) if first
                         else None})
        return out

    cap.path = "D"
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    ds.preprocess_frame, system.process_frame, mp.bundle_adjustment_loop = pre, proc, ba
    try:
        t_run = time.perf_counter()
        infos = system.run()
        run_s = time.perf_counter() - t_run
    finally:
        ds.preprocess_frame, mp.bundle_adjustment_loop = orig_pre, orig_ba
        system.process_frame = orig_proc
        cap.path = None
    counts = dict(_cuda.COUNTS)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the first bundle adjustment again, from its snapshot: the same bits
    repeat_ok = None
    if ba_calls:
        a, kw = ba_calls[0]["snap"]
        feats2, xi2, _ = orig_ba(*a, **kw)
        torch.cuda.synchronize()
        f1, x1 = ba_calls[0]["out"]
        repeat_ok = _bits_equal(feats2, f1) and _bits_equal(xi2, x1)
        del a, kw, feats2, xi2
        for c in ba_calls:
            c.pop("snap"), c.pop("out")

    # deskewing: each frame's points through deskew_points with the motion
    # the dataset used for it, against the sweep's true mid-sweep coordinates
    files, dev = ds.pc_filenames, system.device
    desk, raw = [], []
    for i in range(2, n_frames):
        pts, _, ts = pio.read_point_cloud(files[i])
        p = torch.as_tensor(pts, device=dev)
        d = deskew_points(p, torch.as_tensor(ts.astype(np.float32), device=dev),
                          torch.as_tensor(rel_at[i], dtype=torch.float32, device=dev))
        tr = torch.as_tensor(truth[i], dtype=torch.float64, device=dev)
        desk.append(float(torch.linalg.norm(d.double() - tr, dim=1).mean()))
        raw.append(float(torch.linalg.norm(p.double() - tr, dim=1).mean()))

    poses = np.stack(ds.pgo_poses)
    gt = ds.gt_poses[:len(poses)]
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    odom_err = np.linalg.norm(np.stack(ds.odom_poses)[:, :3, 3] - gt[:, :3, 3], axis=1)
    ba_infos = [dict(frame=i, **x["ba"]) for i, x in enumerate(infos) if x.get("ba")]
    for info, call in zip(ba_infos, ba_calls):
        info.update(call)
    stage = np.asarray(system.stage_times[1:n_frames])
    loop_edges = [(e.i, e.j) for e in system.pgm.edges if abs(e.j - e.i) > 1]
    res = {
        "phase": "path_D", "profile": PATH_D["profile"], "dataset": PATH_D["dataset"],
        "layout": "NCD-128 PLY (x, y, z, intensity, time) + poses.txt, read from disk",
        "weighted_first": cfg.weighted_first, "deskew": cfg.deskew, "frames": n_frames,
        "points_per_frame": [min(n_points), max(n_points)], "beams": PATH_D["n_el"],
        "columns": PATH_D["n_az"], "setup_s": setup_s,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "frame_bucket": cfg.frame_bucket, "pool": cfg.pool_capacity},
        "run_s": run_s,
        # the last frame also clones the kernels' inputs: not timed
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:-1])),
        "frame0_s": times[0],
        "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "ba": ba_infos, "ba_repeat_bit_identical": repeat_ok,
        "deskew_mean_err_m": float(np.mean(desk)), "raw_mean_err_m": float(np.mean(raw)),
        "deskew_err_per_frame_m": desk, "raw_err_per_frame_m": raw,
        "closure_frames": [i for i, x in enumerate(infos) if x.get("pgo_applied")],
        "loop_factors": loop_edges, "after_pgo": system.after_pgo,
        "max_pose_err_m": float(err.max()), "max_odom_err_m": float(odom_err.max()),
        "rmse_m": float(np.sqrt(np.mean(err ** 2))), "metrics": system.metrics,
        "map_points": int(system.state.count), "launches": counts,
        "artifacts": sorted(os.path.relpath(f, cfg.run_path)
                            for f in glob.glob(os.path.join(cfg.run_path, "**"), recursive=True)
                            if os.path.isfile(f)),
        "max_memory_allocated_gb": peak_gb,
    }
    emit(res)
    if not all(res["reg_valid"]):
        bad = [i + 1 for i, v in enumerate(res["reg_valid"]) if not v]
        fail(f"path D: frames {bad} did not register")
    if res["max_pose_err_m"] >= 0.5:
        fail(f"path D: pose error {res['max_pose_err_m']:.3f} m vs the scene's ground truth")
    if [b["frame"] for b in ba_infos] != BA_FRAMES or len(ba_calls) != len(BA_FRAMES):
        fail(f"path D: bundle adjustment ran at {[b['frame'] for b in ba_infos]}, "
             f"expected {BA_FRAMES}")
    for b in ba_infos:
        if not b["loss_finite"] or b["loss_last"] > b["loss_first"]:
            fail(f"path D: bundle adjustment at frame {b['frame']}: loss {b['loss_first']} -> "
                 f"{b['loss_last']}")
        it = 4 * cfg.iters
        if b["gather_launches"] != it or b["scatter_launches"] != it:
            fail(f"path D: bundle adjustment at frame {b['frame']} launched "
                 f"{b['gather_launches']} gathers / {b['scatter_launches']} scatters, "
                 f"expected {it} each")
    if not repeat_ok:
        fail("path D: the first bundle adjustment, rerun from its inputs, differs")
    if not res["deskew_mean_err_m"] <= 0.5 * res["raw_mean_err_m"]:
        fail(f"path D: deskewed points {res['deskew_mean_err_m']:.4f} m from the truth, "
             f"raw {res['raw_mean_err_m']:.4f} m")
    for k in counts:
        if k != "rank" and counts[k] < 1:
            fail(f"path D: kernel {k} never launched")
    if counts["rank"] or cap.plain_rank_calls:
        fail(f"path D: the brick probe went through the per-cell rank kernel "
             f"({counts['rank']}) or the plain brick gather ({cap.plain_rank_calls})")
    res["ba_gather_launches"] = sum(b["gather_launches"] for b in ba_infos)
    res["ba_scatter_launches"] = sum(b["scatter_launches"] for b in ba_infos)
    del system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# the batch CLI on a KITTI-layout sequence
# ----------------------------------------------------------------------

CLI_FRAMES = 8
CLI_ARTIFACTS = {"summary.json", "meta/run.json", "odom_poses_kitti.txt", "odom_poses_tum.txt",
                 "pose_eval.csv", "time_table.npy", "memory_footprint.npy",
                 "map/pin_map.npz", "map/neural_points.ply", "viewer.html"}


def cli_kitti_phase():
    """``pin_slam_torch.cli.main([yaml, "kitti", "00", "--frames", "8"])``
    in-process, on 8 frames of the corridor scene (path B's 128-beam scans)
    written under build/ in the KITTI layout with camera-frame poses and
    calib.txt, and a copy of ``run_kitti.yaml`` whose only changes are
    ``pc_path`` (the dataset root) and ``output_root``.  Gated: return code
    0, 8 frames in summary.json, the artifact set of a run(), the ground
    truth read through calib.txt equal to the scene's within 1e-9 m, finite
    poses, every kernel launched but the pool pass.  The position error is
    reported, not gated: the tracker keeps the profile's own gates here."""
    import glob
    import shutil

    import torch
    import yaml

    from pin_slam_torch import cli
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.indexing import set_dataset_path
    from pin_slam_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.utils import synthetic as syn

    root = os.path.join(ROOT, "build", "cli_kitti")
    shutil.rmtree(root, ignore_errors=True)
    world = syn.make_world(np.random.default_rng(0))
    rng = np.random.default_rng(0)
    scans, poses = [], []
    for i in range(CLI_FRAMES):
        R, t = syn.sensor_pose(i)
        pts = syn.lidar_scan(rng, world, t, R, 1 << 17, n_az=1800, n_el=128)
        scans.append(np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], 1)
                     .astype(np.float32))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T)
    poses = np.stack(poses)
    data = os.path.join(root, "data")
    syn.write_kitti_sequence(data, "00", scans, poses)
    with open(os.path.join(ROOT, "config", "lidar_slam", "run_kitti.yaml")) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["pc_path"] = data
    prof["setting"]["output_root"] = os.path.join(root, "out")
    yml = os.path.join(root, "run_kitti.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    _cuda.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main([yml, "kitti", "00", "--frames", str(CLI_FRAMES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_cuda.COUNTS)
    runs = glob.glob(os.path.join(root, "out", "*"))
    run = runs[0] if len(runs) == 1 else None
    files = sorted(os.path.relpath(p, run) for p in glob.glob(os.path.join(run, "**"),
                                                              recursive=True)
                   if os.path.isfile(p)) if run else []
    summary = {}
    if run and os.path.exists(os.path.join(run, "summary.json")):
        with open(os.path.join(run, "summary.json")) as f:
            summary = json.load(f)
    cfg = Config()
    cfg.load(yml)
    set_dataset_path(cfg, "kitti", "00")
    gt_err = float(np.abs(SLAMDataset(cfg).gt_poses - poses).max())
    est = (np.loadtxt(os.path.join(run, "odom_poses_kitti.txt")).reshape(-1, 3, 4)
           if "odom_poses_kitti.txt" in files else np.zeros((0, 3, 4)))
    res = {"phase": "cli_kitti", "argv": [os.path.relpath(yml, ROOT), "kitti", "00",
                                          "--frames", str(CLI_FRAMES)],
           "rc": rc, "wall_s": wall, "summary": summary, "files": files,
           "gt_via_calib_max_err_m": gt_err,
           "correction_deg": cfg.correction_deg if cfg.kitti_correction_on else 0.0,
           "max_pos_err_m": (float(np.linalg.norm(est[:, :, 3] - poses[:len(est), :3, 3],
                                                  axis=1).max()) if len(est) else None),
           "launches": counts,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(res)
    if rc != 0:
        fail(f"cli_kitti: return code {rc}")
    if summary.get("frames") != CLI_FRAMES:
        fail(f"cli_kitti: summary.json says {summary.get('frames')} frames")
    missing = CLI_ARTIFACTS - set(files)
    if missing:
        fail(f"cli_kitti: artifacts missing: {sorted(missing)}")
    if not gt_err < 1e-9:
        fail(f"cli_kitti: the ground truth through calib.txt is {gt_err} m off the scene's")
    if len(est) != CLI_FRAMES or not np.isfinite(est).all():
        fail("cli_kitti: the trajectory is incomplete or not finite")
    # 8 frames close no loop and run no BA: no pool pass
    for k in counts:
        if k not in ("rank", "pool_pass") and counts[k] < 1:
            fail(f"cli_kitti: kernel {k} never launched")
    shutil.rmtree(root, ignore_errors=True)
    return res


# ----------------------------------------------------------------------
# path E: the RGB-D colour profile through the batch CLI
# ----------------------------------------------------------------------

PATH_E = dict(profile="config/rgbd_slam/run_replica.yaml", seq="room0", n_frames=41,
              stride=2)
E_BA_FRAMES = [39]                # ba_freq_frame 20 past ba_frame // 2 = 25
E_RERUN_FRAME = 5                 # the training call rerun from its snapshot
E_GATE_POS_M = 0.2                # tests/test_rgbd.py's position gate
E_GATE_COLOR = 0.2                # its colour-regression gate (mean absolute error)


def write_path_e_data():
    """The RGB-D room rendered by a 1200 x 680 camera with Replica's
    intrinsics along ``rgbd_pose``'s path (depth quantised to 16 bits at
    6553.5, colour to 8 bits), back-projected at stride 2 by
    ``converters.backproject_depth`` and written in the layout
    ``converters.convert_replica`` writes (``rgbd_ply/*.ply``, ``poses.txt``)
    under build/.  Returns (sequence directory, points a frame, seconds)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from pin_slam_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "path_e")
    shutil.rmtree(root, ignore_errors=True)
    n = PATH_E["n_frames"]
    poses = [syn.rgbd_pose(i, n) for i in range(n)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        frames = list(ex.map(syn.render_rgbd, poses))
    seq = os.path.join(root, PATH_E["seq"])
    counts = syn.write_rgbd_sequence(seq, [d for d, _ in frames], [c for _, c in frames], poses,
                                     stride=PATH_E["stride"])
    return seq, counts, time.perf_counter() - t0


def run_path_e(cap):
    """Path E: ``run_replica.yaml`` as shipped (colour head, photometric
    tracking, BA every 20 frames, save_map and save_mesh), a copy changed
    only in ``pc_path``, ``pose_path`` and ``output_root``, through
    ``pin_slam_torch.cli.main`` in process, on the RGB-D room written under
    build/.  Each frame is timed (synchronised); the BA call is timed and
    its row-kernel launches counted; one training call (frame
    E_RERUN_FRAME's) is rerun from a snapshot of its inputs.  Gated (see
    the module docstring) and reported."""
    import glob

    import torch
    import yaml

    from pin_slam_torch import cli
    from pin_slam_torch.dataset import io as pio
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.models.decoder import blended_head, regress_color
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_torch.utils.experiment import load_implicit_map

    seq, n_points, setup_s = write_path_e_data()
    with open(os.path.join(ROOT, PATH_E["profile"])) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["pc_path"] = os.path.join(seq, "rgbd_ply")
    prof["setting"]["pose_path"] = os.path.join(seq, "poses.txt")
    prof["setting"]["output_root"] = os.path.join(os.path.dirname(seq), "out")
    yml = os.path.join(os.path.dirname(seq), "run_replica.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    n_frames = PATH_E["n_frames"]
    got, infos, times, ba_calls, rerun = {}, [], [], [], {}
    orig_proc, orig_save = SlamSystem.process_frame, SlamSystem.save_artifacts
    orig_loop, orig_ba = mp.mapping_loop_cached, mp.bundle_adjustment_loop

    def proc(self, frame):
        got["system"] = self
        cap.store = self.frame_id == n_frames - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            infos.append(orig_proc(self, frame))
            return infos[-1]
        finally:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            cap.store = False

    def save(self, run_path):
        torch.cuda.synchronize()
        got["frames_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = orig_save(self, run_path)
        torch.cuda.synchronize()
        got["save_s"] = time.perf_counter() - t0
        got["save_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        got["run_path"] = run_path
        return out

    def loop(*a, **kw):
        system = got.get("system")
        if "snap" in rerun or system is None or system.frame_id != E_RERUN_FRAME:
            return orig_loop(*a, **kw)
        rerun["snap"] = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()})
        out = orig_loop(*a, **kw)
        color = kw["color"]
        rerun["out"] = [out[1].clone(), out[2].clone(), color.features.clone()] + \
            [p.clone() for p in color.params]
        return out

    def ba(*a, **kw):
        torch.cuda.synchronize()
        c0 = dict(_cuda.COUNTS)
        t0 = time.perf_counter()
        cap.in_ba = True
        try:
            out = orig_ba(*a, **kw)
            torch.cuda.synchronize()
        finally:
            cap.in_ba = False
        ba_calls.append({"loop_ms": (time.perf_counter() - t0) * 1e3,
                         "gather_launches": _cuda.COUNTS["gather"] - c0["gather"],
                         "scatter_launches": _cuda.COUNTS["scatter"] - c0["scatter"]})
        return out

    cap.path = "E"
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    torch.cuda.synchronize()
    # what the earlier paths left allocated (their captured kernel inputs)
    # is in the peak too: reported apart
    at_start_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    SlamSystem.process_frame, SlamSystem.save_artifacts = proc, save
    mp.mapping_loop_cached, mp.bundle_adjustment_loop = loop, ba
    try:
        t_run = time.perf_counter()
        rc = cli.main([yml])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        SlamSystem.process_frame, SlamSystem.save_artifacts = orig_proc, orig_save
        mp.mapping_loop_cached, mp.bundle_adjustment_loop = orig_loop, orig_ba
        cap.path = None
    counts = dict(_cuda.COUNTS)
    system = got.get("system")
    if rc != 0 or system is None:
        fail(f"path E: the CLI returned {rc}")

    # the snapshotted training call again: the same bits
    repeat_ok = None
    if "snap" in rerun:
        a, kw = rerun["snap"]
        out = orig_loop(*a, **kw)
        color = kw["color"]
        again = [out[1], out[2], color.features] + list(color.params)
        repeat_ok = all(_bits_equal(x, y) for x, y in zip(again, rerun["out"]))
        del a, kw, out, again, rerun["snap"]

    ds, cfg, mc = system.dataset, system.config, system.mc
    est = np.stack(ds.odom_poses)
    gt = ds.gt_poses[:len(est)]
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)

    # colours regressed at the map's points with a full neighbourhood (the
    # JAX package's RGB-D test, every point of the finalised map)
    count = int(system.state.count)
    pts = system.state.positions[:count]
    errs, n_full = [], 0
    with torch.no_grad():
        for s in range(0, count, 1 << 16):
            p = pts[s:s + (1 << 16)]
            knn = npts.knn_search(system.lm, mc, p, system.offsets)
            _, col, w, _ = npts.interpolate_features(system.lm, mc, p, knn.lidx,
                                                     query_color=True)
            pred = blended_head(regress_color, system.color_decoder, col, w, mc.weighted_first)
            full = knn.nn_count >= 6
            target = torch.as_tensor(syn.world_color(p.cpu().numpy()), device=p.device)
            errs.append(torch.abs(pred - target)[full].sum(0).cpu().numpy())
            n_full += int(full.sum())
    color_mae = float(np.sum(errs) / max(3 * n_full, 1))

    # the painted mesh as written, and the saved map reloaded in the port
    run_path = got["run_path"]
    mesh = pio.read_ply(os.path.join(run_path, "mesh", "mesh.ply")) \
        if os.path.exists(os.path.join(run_path, "mesh", "mesh.ply")) else {}
    mverts = (np.stack([mesh["x"], mesh["y"], mesh["z"]], 1) if "x" in mesh
              else np.zeros((0, 3), np.float32))
    mcols = (np.stack([mesh["red"], mesh["green"], mesh["blue"]], 1).astype(np.float64) / 255.0
             if "red" in mesh else None)
    mesh_mae = (float(np.abs(mcols - syn.world_color(mverts)).mean())
                if mcols is not None and len(mverts) else None)
    state2, geo2, col2 = load_implicit_map(os.path.join(run_path, "map", "pin_map.npz"), mc,
                                           color=True)
    reload_ok = (col2 is not None and state2.color_features is not None
                 and int(state2.count) == count
                 and torch.equal(state2.color_features[:count],
                                 system.state.color_features[:count])
                 and torch.equal(state2.geo_features[:count], system.state.geo_features[:count])
                 and all(torch.equal(x, y) for x, y in zip(col2.state_dict().values(),
                                                           system.color_decoder.state_dict()
                                                           .values())))
    del state2, geo2, col2

    photo = [int(x.get("photo_count", 0)) for x in infos[1:]]
    ba_infos = [dict(frame=i, **x["ba"]) for i, x in enumerate(infos) if x.get("ba")]
    for info, call in zip(ba_infos, ba_calls):
        info.update(call)
    stage = np.asarray(system.stage_times[1:n_frames])
    n_iter = cfg.iters * (n_frames + cfg.init_iter_ratio - 1)
    res = {
        "phase": "path_E", "profile": PATH_E["profile"], "argv": [os.path.relpath(yml, ROOT)],
        "layout": "Replica converted: rgbd_ply/*.ply (x, y, z, RGB) + poses.txt, from disk",
        "camera": "1200 x 680, fx = fy = 600, stride 2", "rc": rc,
        "weighted_first": cfg.weighted_first, "frames": len(infos),
        "points_per_frame": [min(n_points), max(n_points)], "setup_s": setup_s,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "frame_bucket": cfg.frame_bucket, "source_bucket": cfg.source_bucket,
                       "pool": cfg.pool_capacity},
        "run_s": run_s, "save_artifacts_s": got.get("save_s"),
        "save_artifacts_peak_gb": got.get("save_peak_gb"),
        # the last frame also clones the kernels' inputs: not timed
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:-1])),
        "frame0_s": times[0],
        "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "reg_iters": [int(x.get("reg_iters", 0)) for x in infos[1:]],
        "reg_iters_mean": float(np.mean([int(x.get("reg_iters", 0)) for x in infos[1:]])),
        "photo_count_min": min(photo) if photo else 0, "photo_count_mean": float(np.mean(photo)),
        "ba": ba_infos, "train_rerun_bit_identical": repeat_ok,
        "max_pose_err_m": float(err.max()), "end_pose_err_m": float(err[-1]),
        "map_points": count, "map_points_full_nbhd": n_full, "color_mae": color_mae,
        "mesh_vertices": int(len(mverts)), "mesh_has_colors": mcols is not None,
        "mesh_color_range": ([float(mcols.min()), float(mcols.max())]
                             if mcols is not None and len(mcols) else None),
        "mesh_color_mae": mesh_mae, "map_reload_ok": reload_ok, "metrics": system.metrics,
        "launches": counts,
        "color_gathers": cap.tally.get(("E", "gather", "color"), 0),
        "color_scatters": cap.tally.get(("E", "scatter", "color"), 0),
        "artifacts": sorted(os.path.relpath(f, run_path)
                            for f in glob.glob(os.path.join(run_path, "**"), recursive=True)
                            if os.path.isfile(f)),
        "allocated_at_start_gb": at_start_gb, "frames_peak_gb": got.get("frames_peak_gb"),
        "max_memory_allocated_gb": max(got.get("frames_peak_gb", 0.0),
                                       got.get("save_peak_gb", 0.0)),
        "nvidia_smi": smi_line(),
    }
    emit(res)
    if len(infos) != n_frames:
        fail(f"path E: {len(infos)} frames ran, expected {n_frames}")
    if not all(res["reg_valid"]):
        bad = [i + 1 for i, v in enumerate(res["reg_valid"]) if not v]
        fail(f"path E: frames {bad} did not register")
    if not res["max_pose_err_m"] < E_GATE_POS_M:
        fail(f"path E: pose error {res['max_pose_err_m']:.3f} m vs the room's ground truth")
    if not color_mae < E_GATE_COLOR or n_full == 0:
        fail(f"path E: colours regressed at {n_full} map points {color_mae:.3f} from the field")
    if not len(mverts) or mcols is None or not np.isfinite(mcols).all() \
            or mcols.min() < 0.0 or mcols.max() > 1.0 or not mesh_mae < E_GATE_COLOR:
        fail(f"path E: painted mesh: {len(mverts)} vertices, colours "
             f"{res['mesh_color_range']}, error {mesh_mae}")
    if not reload_ok:
        fail("path E: pin_map.npz does not reload with its colour features and decoder")
    if not photo or min(photo) <= 0:
        fail(f"path E: the photometric term had no points on some frame: {photo}")
    if [b["frame"] for b in ba_infos] != E_BA_FRAMES or len(ba_calls) != len(E_BA_FRAMES):
        fail(f"path E: bundle adjustment ran at {[b['frame'] for b in ba_infos]}, "
             f"expected {E_BA_FRAMES}")
    for b in ba_infos:
        if not b["loss_finite"] or b["loss_last"] > b["loss_first"]:
            fail(f"path E: bundle adjustment at frame {b['frame']}: loss {b['loss_first']} -> "
                 f"{b['loss_last']}")
    if not repeat_ok:
        fail("path E: the training call rerun from its inputs differs")
    for k in counts:
        if k not in ("rank", "track_step") and counts[k] < 1:
            fail(f"path E: kernel {k} never launched")
    if counts["track_step"]:
        fail(f"path E: the colour tracker launched the track-step kernel {counts['track_step']} "
             f"times")
    if counts["rank"] or cap.plain_rank_calls:
        fail(f"path E: the brick probe went through the per-cell rank kernel "
             f"({counts['rank']}) or the plain brick gather ({cap.plain_rank_calls})")
    if counts["train_iter"] < n_iter or res["color_gathers"] != counts["train_iter"] \
            or res["color_scatters"] != counts["train_iter"]:
        fail(f"path E: {counts['train_iter']} training iterations (>= {n_iter} expected), "
             f"{res['color_gathers']} colour gathers, {res['color_scatters']} colour scatters")
    res["ba_gather_launches"] = sum(b["gather_launches"] for b in ba_infos)
    res["ba_scatter_launches"] = sum(b["scatter_launches"] for b in ba_infos)
    del system, got
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# path F: the semantic LiDAR profile (SemanticKITTI labels) through the CLI
# ----------------------------------------------------------------------

PATH_F = dict(profile="config/lidar_slam/run_kitti.yaml", seq="00", n_frames=16,
              n_points=1 << 17, density=2.5, seed=0)
F_OPTIONS = dict(semantic_on=True, filter_moving_object=True, dynamic_filter_on=True,
                 estimate_normal=True)
F_CAPACITIES = dict(pool_capacity=1 << 23, mapping_bucket=1 << 16)   # path B's
F_RERUN_FRAME = 5                 # the training call rerun from its snapshot
F_GATE_POS_M = 0.5
F_GATE_SEM = 0.8                  # tests/test_semantic.py's head accuracy gate
F_GATE_MESH_SEM = 0.8             # mesh vertices with their nearest surface's class
F_GATE_STATIC_KEEP = 0.99         # static surface points the dynamic filter keeps
F_GATE_NORMALS = 0.5              # valid source points with a valid normal, every frame
# the share of the car's points (frames from CAR_ENTER on) that the dynamic
# filter must drop at least: the JAX package's share on the same scene at a
# reduced size on the CPU, 0.1723 of 1,294 car points at 2^13 points a
# sweep (scripts/dynamic_filter_cpu.py), rounded down
F_GATE_CAR_DROP = 0.17
F_ROAD, F_BUILDING, F_PERSON = 9, 13, 6


def write_path_f_data():
    """The labelled corridor (``synthetic.labelled_corridor_scans``, seed 0,
    16 sweeps of up to 2^17 points) written under build/ in the
    SemanticKITTI layout with KITTI's 0.195 deg intrinsic correction undone
    (run_kitti.yaml's reader applies it).  Returns (sequence directory,
    raw labels, poses, static world, points a frame, seconds)."""
    import shutil

    from pin_slam_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "path_f")
    shutil.rmtree(root, ignore_errors=True)
    scans, labels, poses, world = syn.labelled_corridor_scans(
        PATH_F["seed"], PATH_F["n_frames"], PATH_F["n_points"], density=PATH_F["density"])
    seq = syn.write_semantic_kitti_sequence(os.path.join(root, "data"), PATH_F["seq"], scans,
                                            labels, poses, correction_deg=0.195)
    return seq, labels, poses, world, [len(s) for s in scans], time.perf_counter() - t0


def _section_of(key):
    from pin_slam_torch.config import Config

    return next((s for s, keys in Config._SECTION_KEYS.items()
                 if key in keys or key in keys.values()), None)


def _scene_reference(world, n_frames):
    """(points, learning classes) of every surface the labelled corridor
    showed: the static world, and the car at each frame's position."""
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_torch.utils.semantic_kitti import apply_learning_map

    pts, lab = [world[0]], [world[2]]
    rng = np.random.default_rng(1)
    for i in range(n_frames):
        mp_, _, ml = syn.corridor_movers(rng, i, PATH_F["density"])
        car = ml == syn.RAW_CAR
        pts.append(mp_[car])
        lab.append(ml[car])
    return np.concatenate(pts), apply_learning_map(np.concatenate(lab).astype(np.int64))


def run_path_f(cap):
    """Path F: a copy of ``run_kitti.yaml`` changed in its paths, in
    semantic_on, dynamic_filter_on and estimate_normal (filter_moving_object
    is True by default and has no YAML key in either package) and to path
    B's KITTI capacities (``F_CAPACITIES``), through ``pin_slam_torch.cli.main``
    in process on the labelled corridor written under build/.  The semantic
    head trains by the autograd loop (gather kernel forward, in-order
    scatter kernel backward); the training kernels do not launch.  Gated
    (see the module docstring) and reported."""
    import torch
    import yaml
    from scipy.spatial import cKDTree

    from pin_slam_torch import cli
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.models.decoder import blended_head, sem_label_prob
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_torch.utils.experiment import load_implicit_map

    seq, raw_labels, gt_poses, world, n_points, setup_s = write_path_f_data()
    with open(os.path.join(ROOT, PATH_F["profile"])) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["pc_path"] = os.path.join(seq, "velodyne")
    prof["setting"]["label_path"] = os.path.join(seq, "labels")
    prof["setting"]["pose_path"] = os.path.join(seq, "poses.txt")
    prof["setting"]["calib_path"] = os.path.join(seq, "calib.txt")
    prof["setting"]["output_root"] = os.path.join(os.path.dirname(os.path.dirname(seq)), "out")
    for key in ("semantic_on", "dynamic_filter_on", "estimate_normal"):
        prof.setdefault(_section_of(key), {})[key] = True
    # path B's KITTI capacities: its pool and mapping bucket (the profile
    # ships a 2e7 pool and no mapping bucket; map, local map and frame
    # bucket are the profile's own, 2^22, 2^18 and 2^17)
    for key, v in F_CAPACITIES.items():
        prof.setdefault(_section_of(key), {})[key] = v
    yml = os.path.join(os.path.dirname(os.path.dirname(seq)), "run_kitti_semantic.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    n_frames = PATH_F["n_frames"]
    got, infos, times, frames, masks, nrm_share, calls, rerun = {}, [], [], {}, {}, {}, [], {}
    orig = (SlamSystem.process_frame, SlamSystem.save_artifacts, SlamSystem.dynamic_static_mask,
            SlamSystem._source_normals, mp.mapping_loop_autograd)

    def proc(self, frame):
        got["system"] = self
        frames[self.frame_id] = (frame.valid.copy(), frame.sem_labels.copy(),
                                 frame.points.copy())
        cap.store = self.frame_id == n_frames - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            infos.append(orig[0](self, frame))
            return infos[-1]
        finally:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            cap.store = False

    def save(self, run_path):
        torch.cuda.synchronize()
        got["frames_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        out = orig[1](self, run_path)
        torch.cuda.synchronize()
        got["save_s"] = time.perf_counter() - t0
        got["run_path"] = run_path
        return out

    def dyn(self, points, R, t):
        keep = orig[2](self, points, R, t)
        masks[self.frame_id] = keep.cpu().numpy()
        return keep

    def normals(self, src, src_valid):
        nrm, nv = orig[3](self, src, src_valid)
        nrm_share[self.frame_id] = float((nv & src_valid).sum()) / max(int(src_valid.sum()), 1)
        return nrm, nv

    def loop(*a, **kw):
        system = got.get("system")
        snap = ("snap" not in rerun and system is not None
                and system.frame_id == F_RERUN_FRAME)
        if snap:
            rerun["snap"] = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig[4](*a, **kw)
        torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "iters": int(out[4].shape[0]),
                      "loss_first": float(out[4][0]), "loss_last": float(out[4][-1]),
                      "finite": bool(torch.isfinite(out[4]).all())})
        if snap:
            rerun["out"] = [out[1].clone()] + [p.clone() for p in out[2].leaves()]
        return out

    cap.path = "F"
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    torch.cuda.synchronize()
    at_start_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    (SlamSystem.process_frame, SlamSystem.save_artifacts, SlamSystem.dynamic_static_mask,
     SlamSystem._source_normals, mp.mapping_loop_autograd) = proc, save, dyn, normals, loop
    try:
        t_run = time.perf_counter()
        rc = cli.main([yml])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        (SlamSystem.process_frame, SlamSystem.save_artifacts, SlamSystem.dynamic_static_mask,
         SlamSystem._source_normals, mp.mapping_loop_autograd) = orig
        cap.path = None
    counts = dict(_cuda.COUNTS)
    system = got.get("system")
    if rc != 0 or system is None:
        fail(f"path F: the CLI returned {rc}")
    cfg, mc = system.config, system.mc

    repeat_ok = None
    if "snap" in rerun:
        a, kw = rerun["snap"]
        out = orig[4](*a, **kw)
        again = [out[1]] + list(out[2].leaves())
        repeat_ok = all(_bits_equal(x, y) for x, y in zip(again, rerun["out"]))
        del a, kw, out, again, rerun["snap"]

    ds = system.dataset
    est = np.stack(ds.odom_poses)
    err = np.linalg.norm(est[:, :3, 3] - ds.gt_poses[:len(est), :3, 3], axis=1)

    # the pool's classes
    pool_classes = sorted(int(c) for c in torch.unique(system.pool.sem_label).cpu())
    scene_classes = {0} | set(int(c) for c in np.unique(np.concatenate(
        [f[1][f[0]] for f in frames.values()])))

    # the semantic head at observed road and building points of the last
    # sweep (world coordinates through the ground truth)
    last = n_frames - 1
    rng = np.random.default_rng(2)
    v_last, lab_last, pts_last = frames[last]
    T = ds.gt_poses[last]
    scan_w = pts_last.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
    acc = {}
    queries = {}
    for name, cls in (("road", F_ROAD), ("building", F_BUILDING)):
        cand = np.nonzero(v_last & (lab_last == cls))[0]
        q = scan_w[rng.choice(cand, 256, replace=False)].astype(np.float32)
        queries[name] = q
        with torch.no_grad():
            qt = torch.as_tensor(q, device=system.device)
            knn = npts.knn_search(system.lm, mc, qt, system.offsets)
            feat, w, _ = npts.interpolate_features(system.lm, mc, qt, knn.lidx)
            pred = torch.argmax(blended_head(sem_label_prob, system.sem_decoder, feat, w,
                                             mc.weighted_first), -1).cpu().numpy()
        acc[name] = float(np.mean(pred == cls))

    # the finalised map's mesh (recon_aabb_mesh, chunk by chunk; the
    # profile does not save one): its vertex classes against the nearest
    # scene surface's
    t0 = time.perf_counter()
    count = int(system.state.count)
    verts, _, _ = system.mesh_map(system.state.positions[:count].cpu().numpy())
    mesh_s = time.perf_counter() - t0
    vsem = system.mesh_sem_labels
    ref_pts, ref_cls = _scene_reference(world, n_frames)
    mesh_acc = (float(np.mean(ref_cls[cKDTree(ref_pts).query(verts)[1]] == vsem))
                if len(verts) and vsem is not None else 0.0)

    # the dynamic filter: the car's points dropped, the static points kept
    car_n = car_drop = st_n = st_keep = 0
    per_frame_drop = {}
    for i, keep in masks.items():
        v, lab, _ = frames[i]
        car = v & (lab == 1)
        st = v & np.isin(lab, (F_ROAD, F_BUILDING, 18))
        st_n += int(st.sum())
        st_keep += int((st & keep).sum())
        if i >= syn.CAR_ENTER:
            car_n += int(car.sum())
            car_drop += int((car & ~keep).sum())
            per_frame_drop[i] = float((car & ~keep).sum() / max(car.sum(), 1))
    car_share = car_drop / max(car_n, 1)
    static_share = st_keep / max(st_n, 1)

    # the saved map with its semantic head, reloaded in the port
    state2, _, sem2 = load_implicit_map(os.path.join(got["run_path"], "map", "pin_map.npz"), mc,
                                        semantic=True)
    reload_ok = sem2 is not None and all(
        torch.equal(x, y) for x, y in zip(sem2.state_dict().values(),
                                          system.sem_decoder.state_dict().values()))
    with torch.no_grad():
        qt = torch.as_tensor(np.concatenate([queries["road"], queries["building"]]),
                             device=system.device)
        knn = npts.knn_search(system.lm, mc, qt, system.offsets)
        feat, w, _ = npts.interpolate_features(system.lm, mc, qt, knn.lidx)
        a1 = torch.argmax(blended_head(sem_label_prob, system.sem_decoder, feat, w,
                                       mc.weighted_first), -1)
        a2 = torch.argmax(blended_head(sem_label_prob, sem2, feat, w, mc.weighted_first), -1)
    reload_ok = reload_ok and bool(torch.equal(a1, a2))
    del state2, sem2

    stage = np.asarray(system.stage_times[1:n_frames])
    iters = sum(c["iters"] for c in calls)
    res = {
        "phase": "path_F", "profile": PATH_F["profile"], "argv": [os.path.relpath(yml, ROOT)],
        "options": {k: getattr(cfg, k) for k in F_OPTIONS},
        "layout": "SemanticKITTI: velodyne/*.bin, labels/*.label, calib.txt, poses.txt",
        "rc": rc, "weighted_first": cfg.weighted_first, "kernel_path": system.kernel_path,
        "frames": len(infos), "points_per_frame": [min(n_points), max(n_points)],
        "setup_s": setup_s,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "pool": cfg.pool_capacity, "frame_bucket": cfg.frame_bucket,
                       "mapping_bucket": cfg.mapping_bucket, "bs": cfg.bs},
        "run_s": run_s, "save_artifacts_s": got.get("save_s"),
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:-1])),
        "frame0_s": times[0], "stage_ms_mean_after_frame0": _stage_ms(stage),
        "train_ms_per_iter": float(sum(c["ms"] for c in calls) / max(iters, 1)),
        "train_calls": len(calls), "train_iters": iters,
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "max_pose_err_m": float(err.max()), "end_pose_err_m": float(err[-1]),
        "pool_classes": pool_classes, "scene_classes": sorted(scene_classes),
        "sem_accuracy": acc, "mesh_vertices": int(len(verts)), "mesh_s": mesh_s,
        "mesh_res_m": cfg.mc_res_m, "mesh_sem_accuracy": mesh_acc,
        "dynamic_car_points": car_n, "dynamic_car_drop_share": car_share,
        "dynamic_car_drop_per_frame": per_frame_drop, "dynamic_static_keep_share": static_share,
        "normal_valid_share_min": min(nrm_share.values()) if nrm_share else 0.0,
        "normal_valid_share_mean": float(np.mean(list(nrm_share.values()))) if nrm_share else 0.0,
        "map_reload_ok": reload_ok, "train_rerun_bit_identical": repeat_ok,
        "metrics": system.metrics, "launches": counts,
        "allocated_at_start_gb": at_start_gb, "frames_peak_gb": got.get("frames_peak_gb"),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "nvidia_smi": smi_line(),
    }
    emit(res)
    if len(infos) != n_frames:
        fail(f"path F: {len(infos)} frames ran, expected {n_frames}")
    if system.kernel_path or not all(getattr(cfg, k) == v for k, v in F_OPTIONS.items()):
        fail(f"path F: the profile's options {res['options']}, kernel path "
             f"{system.kernel_path}")
    if not all(res["reg_valid"]):
        bad = [i + 1 for i, v in enumerate(res["reg_valid"]) if not v]
        fail(f"path F: frames {bad} did not register")
    if not res["max_pose_err_m"] < F_GATE_POS_M:
        fail(f"path F: pose error {res['max_pose_err_m']:.3f} m vs the corridor's ground truth")
    if not set(pool_classes) <= scene_classes or F_PERSON in pool_classes:
        fail(f"path F: pool classes {pool_classes}, scene classes {sorted(scene_classes)}")
    if min(acc.values()) < F_GATE_SEM:
        fail(f"path F: semantic head accuracy {acc}")
    if not mesh_acc >= F_GATE_MESH_SEM:
        fail(f"path F: {mesh_acc:.3f} of {len(verts)} mesh vertices have their surface's class")
    if car_n == 0 or car_share < F_GATE_CAR_DROP or static_share < F_GATE_STATIC_KEEP:
        fail(f"path F: dynamic filter drops {car_share:.4f} of {car_n} car points "
             f"(>= {F_GATE_CAR_DROP}), keeps {static_share:.4f} of the static ones")
    if not nrm_share or min(nrm_share.values()) < F_GATE_NORMALS:
        fail(f"path F: valid-normal shares {nrm_share}")
    if not reload_ok:
        fail("path F: pin_map.npz does not reload with its semantic head")
    if not repeat_ok:
        fail("path F: the training call rerun from its inputs differs")
    if not all(c["finite"] for c in calls):
        fail("path F: a non-finite training loss")
    for k in ("rank_brick", "gather", "scatter"):
        if counts[k] < 1:
            fail(f"path F: kernel {k} never launched")
    if counts["train_iter"] or counts["eikonal"] or counts["rank"] or cap.plain_rank_calls:
        fail(f"path F: training kernels launched ({counts['train_iter']}, "
             f"{counts['eikonal']}) or the per-cell / plain rank ({counts['rank']}, "
             f"{cap.plain_rank_calls})")
    if counts["scatter"] < iters or counts["gather"] < iters:
        fail(f"path F: {counts['gather']} gathers, {counts['scatter']} scatters for {iters} "
             f"training iterations")
    del system, got
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# path G: the Livox profile as shipped (k = 8, per-neighbour decoding)
# ----------------------------------------------------------------------

PATH_G = dict(profile="config/lidar_slam/run_livox.yaml", n_frames=14, n_points=60000,
              density=2.5, seed=0)
G_GATE_POS_M = 0.5


def write_path_g_data():
    """The labelled corridor's static surfaces seen through a Livox Avia's
    70.4 x 77.2 degree field of view (``synthetic.livox_corridor_scans``,
    seed 0), ``PATH_G["n_frames"]`` sweeps of 60,000 points written as
    binary PCD under build/.  Returns (pcd directory, poses, seconds)."""
    import shutil

    from pin_slam_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "path_g")
    shutil.rmtree(root, ignore_errors=True)
    scans, poses = syn.livox_corridor_scans(PATH_G["seed"], PATH_G["n_frames"],
                                            PATH_G["n_points"], density=PATH_G["density"])
    pcd = syn.write_pcd_sequence(os.path.join(root, "data", "HKU_ZYM", "pcd"), scans)
    return pcd, poses, time.perf_counter() - t0


def run_path_g(cap):
    """Path G: ``run_livox.yaml`` as shipped (k = 8, per-neighbour
    decoding, pool 2e7, map 2^21, local 2^18, frame bucket 2^16, BA off,
    ``mapping_freq_frame: 2``, which both packages read and train every
    frame anyway), a copy changed only in ``pc_path`` and ``output_root``,
    through ``pin_slam_torch.cli.main`` in process on the PCD sweeps of
    ``write_path_g_data``.  The profile gives no poses: the errors are
    against the scene's trajectory taken relative to its first pose.  Gated
    (see the module docstring) and reported."""
    import torch
    import yaml

    from pin_slam_torch import cli
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam.pipeline import SlamSystem

    pcd, gt_poses, setup_s = write_path_g_data()
    with open(os.path.join(ROOT, PATH_G["profile"])) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["pc_path"] = pcd
    prof["setting"]["output_root"] = os.path.join(ROOT, "build", "path_g", "out")
    yml = os.path.join(ROOT, "build", "path_g", "run_livox.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    n_frames = PATH_G["n_frames"]
    got, infos, times = {}, [], []
    orig = SlamSystem.process_frame

    def proc(self, frame):
        got["system"] = self
        cap.store = self.frame_id == n_frames - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            infos.append(orig(self, frame))
            return infos[-1]
        finally:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            cap.store = False

    cap.path = "G"
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SlamSystem.process_frame = proc
    try:
        t_run = time.perf_counter()
        rc = cli.main([yml])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        SlamSystem.process_frame = orig
        cap.path = None
    counts = dict(_cuda.COUNTS)
    system = got.get("system")
    if rc != 0 or system is None:
        fail(f"path G: the CLI returned {rc}")
    cfg, mcfg = system.config, system.mcfg
    est = np.stack(system.dataset.odom_poses)
    rel = np.linalg.inv(gt_poses[0]) @ gt_poses[:len(est)]
    err = np.linalg.norm(est[:, :3, 3] - rel[:, :3, 3], axis=1)

    # the pool's rows: 8 neighbour ids, 8 IDW weights summing to 1 on rows
    # that have a neighbour
    fill = int(system.pool.fill)
    rows = system.pool.rows[:fill]
    gidx = rows[:, mcfg.p_knn]
    wsum = rows[:, mcfg.p_w].sum(1)
    has = (gidx >= 0).any(1) & (rows[:, 5] >= 0)       # a neighbour, a frame id
    w_err = float((wsum[has] - 1.0).abs().max()) if bool(has.any()) else float("inf")
    ids_ok = bool(((gidx == -1) | ((gidx >= 0) & (gidx == gidx.round()))).all())
    train_k = [cap.inputs[("G", kern, "main")][0][0].shape[1]
               for kern in ("train_iter", "eikonal") if ("G", kern, "main") in cap.inputs]

    stage = np.asarray(system.stage_times[1:n_frames])
    res = {
        "phase": "path_G", "profile": PATH_G["profile"], "argv": [os.path.relpath(yml, ROOT)],
        "layout": "a folder of binary PCD sweeps (x, y, z, intensity), no poses",
        "rc": rc, "query_nn_k": cfg.query_nn_k, "weighted_first": cfg.weighted_first,
        "mapping_freq_frame": cfg.mapping_freq_frame, "kernel_path": system.kernel_path,
        "frames": len(infos), "points_per_frame": PATH_G["n_points"], "setup_s": setup_s,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "pool": cfg.pool_capacity, "frame_bucket": cfg.frame_bucket,
                       "bs": cfg.bs},
        "pool_dim": mcfg.pool_dim, "pool_fill": fill,
        "pool_rows_with_neighbour": int(has.sum()), "pool_weight_sum_max_err": w_err,
        "run_s": run_s, "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:-1])),
        "frame0_s": times[0], "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
        "max_pose_err_m": float(err.max()), "end_pose_err_m": float(err[-1]),
        "training_kernel_k": train_k, "launches": counts,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "nvidia_smi": smi_line(),
    }
    emit(res)
    if len(infos) != n_frames:
        fail(f"path G: {len(infos)} frames ran, expected {n_frames}")
    if cfg.query_nn_k != 8 or cfg.weighted_first or not system.kernel_path:
        fail(f"path G: the profile's k {cfg.query_nn_k}, weighted_first {cfg.weighted_first}, "
             f"kernel path {system.kernel_path}")
    if not all(res["reg_valid"]):
        bad = [i + 1 for i, v in enumerate(res["reg_valid"]) if not v]
        fail(f"path G: frames {bad} did not register")
    if not res["max_pose_err_m"] < G_GATE_POS_M:
        fail(f"path G: pose error {res['max_pose_err_m']:.3f} m vs the corridor's trajectory")
    if gidx.shape[1] != 8 or not ids_ok or not bool(has.any()) or not w_err < 1e-5:
        fail(f"path G: pool rows with {gidx.shape[1]} ids (integral {ids_ok}), weights off 1 by "
             f"{w_err:.3e} on {int(has.sum())} rows with a neighbour")
    if train_k != [8, 8]:
        fail(f"path G: the training kernels ran at k = {train_k}")
    if any(counts[k] < 1 for k in ("rank_brick", "train_iter", "eikonal", "gather", "scatter")):
        fail(f"path G: launches {counts}")
    if counts["rank"] or cap.plain_rank_calls:
        fail(f"path G: the per-cell rank ({counts['rank']}) or the plain brick gather "
             f"({cap.plain_rank_calls}) ran")
    del system, got, rows
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# the exact-kNN training loop (PIN_SLAM_EXACT_KNN=1)
# ----------------------------------------------------------------------

EXACT_FRAMES = 4
EXACT_RERUN_FRAME = 2
EXACT_PHASES = {"exact_A": ("A", {}), "exact_B_ln": ("B", dict(layer_norm_on=True))}


def exact_phase(name, cap):
    """``PIN_SLAM_EXACT_KNN=1`` on a path's profile and capacities, 4 corridor
    frames: every frame trains with ``mapper.mapping_loop`` (a fresh kNN per
    batch, autograd; path A's weighted_first, path B's per-neighbour with
    feature layer-norm).  Gated: every frame after the first registers, the
    position error under 0.5 m, finite losses, frame 2's training call rerun
    from a snapshot of its inputs bit-identical, no training-kernel launch,
    the feature gather and its gradient's in-order scatter once an
    iteration each.  The row kernels' launches are tallied under the
    phase's name and the last frame's inputs kept (``cap.store``) for the
    kernel rows: the pool rows' and the feature rows' gather, the feature
    gradient's scatter and the certainty sum's."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp

    path, over = EXACT_PHASES[name]
    os.environ["PIN_SLAM_EXACT_KNN"] = "1"
    try:
        system, frames, gt = make_path(path, EXACT_FRAMES, over=over)
    finally:
        os.environ.pop("PIN_SLAM_EXACT_KNN", None)
    calls, rerun, orig = [], {}, mp.mapping_loop

    def loop(*a, **kw):
        snap = "snap" not in rerun and system.frame_id == EXACT_RERUN_FRAME
        if snap:
            rerun["snap"] = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()})
        cap.store = system.frame_id == len(frames) - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = orig(*a, **kw)
            torch.cuda.synchronize()
        finally:
            cap.store = False
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "iters": int(out[4].shape[0]),
                      "loss_first": float(out[4][0]), "loss_last": float(out[4][-1]),
                      "finite": bool(torch.isfinite(out[4]).all())})
        if snap:
            rerun["out"] = ([out[0].attr_rows.clone(), out[1].clone()]
                            + [p.clone() for p in out[2].leaves()])
        return out

    cfg = system.config
    _cuda.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mp.mapping_loop = loop
    cap.path, cap.slim = name, True
    t0 = time.perf_counter()
    try:
        infos = [system.process_frame(f) for f in frames]
        torch.cuda.synchronize()
    finally:
        mp.mapping_loop = orig
        cap.path, cap.slim = None, False
    wall = time.perf_counter() - t0
    counts = dict(_cuda.COUNTS)
    repeat_ok = None
    if "snap" in rerun:
        a, kw = rerun["snap"]
        out = orig(*a, **kw)
        again = [out[0].attr_rows, out[1]] + list(out[2].leaves())
        repeat_ok = all(_bits_equal(x, y) for x, y in zip(again, rerun["out"]))
        del a, kw, out, again, rerun["snap"]
    poses = np.stack(system.dataset.odom_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    iters = sum(c["iters"] for c in calls)
    stage = np.asarray(system.stage_times[1:])
    res = {"phase": name, "profile": PATHS[path]["profile"] or "default (weighted_first)",
           "weighted_first": cfg.weighted_first, "layer_norm_on": cfg.layer_norm_on,
           "exact_knn": system.exact_knn, "kernel_path": system.kernel_path,
           "frames": len(infos), "wall_s": wall, "stage_ms_mean_after_frame0": _stage_ms(stage),
           "train_calls": len(calls), "train_iters": iters,
           "train_ms_per_iter": float(sum(c["ms"] for c in calls) / max(iters, 1)),
           "loss_first_call": [calls[0]["loss_first"], calls[0]["loss_last"]] if calls else None,
           "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
           "max_pose_err_m": float(err.max()), "train_rerun_bit_identical": repeat_ok,
           "launches": counts,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(res)
    if not system.exact_knn or system.kernel_path or not calls:
        fail(f"{name}: the exact-kNN loop did not train")
    if not all(res["reg_valid"]) or not res["max_pose_err_m"] < 0.5:
        fail(f"{name}: registration {res['reg_valid']}, pose error {res['max_pose_err_m']:.3f} m")
    if not all(c["finite"] for c in calls):
        fail(f"{name}: a non-finite training loss")
    if not repeat_ok:
        fail(f"{name}: frame {EXACT_RERUN_FRAME}'s training call rerun from its inputs differs")
    if counts["train_iter"] or counts["eikonal"]:
        fail(f"{name}: training kernels launched ({counts['train_iter']}, {counts['eikonal']})")
    if counts["gather"] < iters or counts["scatter"] < iters:
        fail(f"{name}: {counts['gather']} gathers, {counts['scatter']} scatters for {iters} "
             f"training iterations")
    for kernel, kinds in (("gather", ("pool", "feat")), ("scatter", ("main", "cert"))):
        if sum(cap.tally.get((name, kernel, x), 0) for x in kinds) != counts[kernel]:
            fail(f"{name}: {kernel} launch tallies disagree with the counter")
        for x in kinds:
            if (name, kernel, x) not in cap.inputs:
                fail(f"{name}: no {kernel} launch of kind {x} captured")
    del system
    torch.cuda.empty_cache()
    return res


TG_FRAMES = 4


def train_general_phase():
    """``run_kitti.yaml`` at path B's capacities on 4 corridor frames with
    ``geo_mlp_level: 2`` and ``mlp_bias_on: False``: an SDF decoder the
    training kernels do not take, trained by the autograd loop.  Gated:
    every frame after the first registers, the position error under 0.5 m,
    every training loss finite, the first call's loss falling, no training
    kernel launched."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp

    system, frames, gt = make_path("B", TG_FRAMES, over=dict(geo_mlp_level=2,
                                                              mlp_bias_on=False))
    hist, orig = [], mp.mapping_loop_autograd

    def loop(*a, **kw):
        out = orig(*a, **kw)
        hist.append(out[4].cpu().numpy())
        return out

    cfg = system.config
    _cuda.reset_counts()
    mp.mapping_loop_autograd = loop
    t0 = time.perf_counter()
    try:
        infos = [system.process_frame(f) for f in frames]
        torch.cuda.synchronize()
    finally:
        mp.mapping_loop_autograd = orig
    wall = time.perf_counter() - t0
    counts = dict(_cuda.COUNTS)
    poses = np.stack(system.dataset.odom_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    res = {"phase": "train_general", "profile": PATHS["B"]["profile"],
           "geo_mlp_level": cfg.geo_mlp_level, "mlp_bias_on": cfg.mlp_bias_on,
           "kernel_path": system.kernel_path, "frames": len(infos), "wall_s": wall,
           "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
           "max_pose_err_m": float(err.max()),
           "loss_first_call": [float(hist[0][0]), float(hist[0][-1])] if hist else None,
           "loss_last_per_call": [float(h[-1]) for h in hist], "launches": counts}
    emit(res)
    if system.kernel_path or not hist:
        fail("train_general: the configuration did not train by the autograd loop")
    if not all(res["reg_valid"]) or not res["max_pose_err_m"] < 0.5:
        fail(f"train_general: registration {res['reg_valid']}, pose error "
             f"{res['max_pose_err_m']:.3f} m")
    if not all(np.isfinite(h).all() for h in hist) or not hist[0][-1] < hist[0][0]:
        fail(f"train_general: losses {res['loss_first_call']} (first call), finite "
             f"{all(np.isfinite(h).all() for h in hist)}")
    if counts["train_iter"] or counts["eikonal"] or counts["gather"] < 1 \
            or counts["scatter"] < 1:
        fail(f"train_general: launches {counts}")
    del system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# end of run: finalisation, saved map, whole-map mesh, evaluation
# ----------------------------------------------------------------------

# numpy and native extraction on one SDF grid (tests/test_native.py's bounds)
NATIVE_VERTS, NATIVE_FACES, NATIVE_CHAMFER = 2, 4, 1e-5


def build_native():
    """Build the optional host extension into build/native; (status, reason)."""
    from pin_slam_torch.utils import native

    try:
        native.build()
    except RuntimeError as e:
        return "unavailable", str(e)[-300:]
    return "built", None


# the multi-chunk mesh against the one-chunk mesh of the same map: the same
# SDF (each view holds every point its grid points reach) up to rounding
MULTI_CHAMFER_FRAC = 0.1


def _xy_span(verts):
    return (verts[:, :2].max(0) - verts[:, :2].min(0)) if len(verts) else np.zeros(2)


def multi_chunk_mesh(system, pts, L):
    """The whole-map mesher once more on the finalised map, with views of
    ``L`` rows instead of the map's local capacity, so that the map needs
    several chunks (``split_chunks`` halving, one ``build_query_view`` each);
    and one view of ``L`` rows over the whole map, which overflows (the
    oldest ``L`` kept), built on the card and on the CPU."""
    import torch

    from pin_slam_torch.models import neural_points as npts

    mc0 = system.mc
    system.mc = dataclasses.replace(mc0, local_capacity=L)
    try:
        verts, faces, counts = system.mesh_map(pts)
        centre = torch.as_tensor(pts.mean(0), dtype=torch.float32)
        radius = np.float32(1e4)
        with torch.no_grad():
            card = npts.build_query_view(system.state, system.mc, centre.to(system.device),
                                         radius)
            cpu_state = dataclasses.replace(
                system.state, **{f.name: getattr(system.state, f.name).cpu()
                                 for f in dataclasses.fields(system.state)
                                 if getattr(system.state, f.name) is not None})
            host = npts.build_query_view(cpu_state, system.mc, centre, radius)
    finally:
        system.mc = mc0
    same = int(host.count) == L < len(pts) and all(
        torch.equal(getattr(card, f).cpu(), getattr(host, f))
        for f in ("indices", "count", "member_mask", "hash_rows", "attr_rows", "geo_features"))
    return {"local_capacity": L, "chunks": len(counts), "view_counts": counts,
            "max_view_count": max(counts, default=0), "vertices": int(len(verts)),
            "faces": int(len(faces)), "finite": bool(np.isfinite(verts).all()),
            "mesh_xy_span_m": _xy_span(verts).tolist(), "verts": verts,
            "overflow_view_count": int(card.count), "overflow_view_equal_cpu": same}


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return float(0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()))


def mesh_phase(name, system):
    """``SlamSystem.save_artifacts`` on the path's final map (after its
    capture frame) with save_map, save_mesh and save_merged_pc on, into a
    temporary run directory under build/, then ``write_results``.  Times
    ``finalize_map`` and the grid queries (synchronised) and each chunk's
    extraction in numpy and, where the extension is built, natively (held
    to NATIVE_*); gates the mesh (non-empty, finite, xy extent >= 0.8 of
    the map's), the saved map's reload, and reports the mesh against the
    scene's surfaces and the trajectory against its ground truth."""
    import shutil
    import tempfile

    import torch

    from pin_slam_torch.eval.mesh import eval_mesh
    from pin_slam_torch.eval.traj import absolute_error
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops import marching_cubes as mcubes
    from pin_slam_torch.slam.mesher import Mesher
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_torch.utils.experiment import load_implicit_map

    cfg, ds = system.config, system.dataset
    cfg.save_map = cfg.save_mesh = cfg.save_merged_pc = True
    if not PATHS[name].get("pgo"):
        # the corridor's frames come from chip_smoke, not the dataset: give
        # the dataset the scene's poses for write_results' evaluation
        n = len(ds.odom_poses)
        ds.gt_poses = np.tile(np.eye(4), (n, 1, 1))
        for i in range(n):
            ds.gt_poses[i, :3, :3], ds.gt_poses[i, :3, 3] = syn.sensor_pose(i)
        ds.gt_pose_provided = True
        world = syn.make_world(np.random.default_rng(0))[0]
    else:
        world = syn.square_world(np.random.default_rng(SQUARE_SEED))[0]
    native_status, native_reason = build_native()

    t = {"finalize_ms": 0.0}

    def zero_counts():
        t.update(query_ms=0.0, points=0, buckets=0, numpy_ms=0.0, native_ms=0.0)

    zero_counts()
    parity = {"max_vert_diff": 0, "max_face_diff": 0, "max_chamfer": 0.0}
    orig_fin, orig_q, orig_mt = npts.finalize_map, Mesher.query_sdf_grid, mcubes.marching_tetrahedra
    before = int(system.state.count)

    def fin(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_fin(*a, **kw)
        torch.cuda.synchronize()
        t["finalize_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def query(self, lm, *a):
        if lm.attr_rows.device.type != "cuda":
            fail(f"mesh {name}: the grid query ran on {lm.attr_rows.device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_q(self, lm, *a)          # ends with its copy to the host
        t["query_ms"] += (time.perf_counter() - t0) * 1e3
        t["points"] += len(a[-1])
        t["buckets"] += -(-len(a[-1]) // self.cfg.query_bucket)
        return out

    def extract(sdf, mask=None, **kw):
        t0 = time.perf_counter()
        v, f = orig_mt(sdf, mask, use_native=False, **kw)
        t["numpy_ms"] += (time.perf_counter() - t0) * 1e3
        if native_status != "built":
            return v, f
        t0 = time.perf_counter()
        vn, fn = orig_mt(sdf, mask, use_native=True, **kw)
        t["native_ms"] += (time.perf_counter() - t0) * 1e3
        parity["max_vert_diff"] = max(parity["max_vert_diff"], abs(len(vn) - len(v)))
        parity["max_face_diff"] = max(parity["max_face_diff"], abs(len(fn) - len(f)))
        if len(v) and len(vn):
            parity["max_chamfer"] = max(parity["max_chamfer"], _chamfer(vn, v))
        return vn, fn

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix=f"mesh_{name}_", dir=os.path.join(ROOT, "build"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    npts.finalize_map, Mesher.query_sdf_grid, mcubes.marching_tetrahedra = fin, query, extract
    try:
        t0 = time.perf_counter()
        mesh = system.save_artifacts(run_dir)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        main = dict(t)
        metrics = ds.write_results(run_dir)
        after = int(system.state.count)
        pts = system.state.positions[:after].cpu().numpy()
        multi = None
        if PATHS[name].get("multi_chunk_L"):
            zero_counts()
            multi = multi_chunk_mesh(system, pts, PATHS[name]["multi_chunk_L"])
            multi.update(grid_points=t["points"], query_buckets=t["buckets"],
                         grid_query_ms=t["query_ms"],
                         grid_points_per_s=t["points"] / max(t["query_ms"], 1e-9) * 1e3,
                         extract_numpy_ms=t["numpy_ms"])
    finally:
        npts.finalize_map, Mesher.query_sdf_grid, mcubes.marching_tetrahedra = (
            orig_fin, orig_q, orig_mt)
    files = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                   for d, _, names in os.walk(run_dir) for f in names)

    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), [])
    verts, faces, view_counts = mesh if mesh is not None else empty
    span_pts = pts[:, :2].max(0) - pts[:, :2].min(0)
    span_mesh = _xy_span(verts)
    if multi is not None:
        mverts = multi.pop("verts")
        multi["chamfer_to_one_chunk_m"] = (_chamfer(mverts, verts)
                                           if len(verts) and len(mverts) else None)
    state2, dec2 = load_implicit_map(os.path.join(run_dir, "map", "pin_map.npz"), system.mc,
                                     system.device)
    reload_ok = (int(state2.count) == after
                 and torch.equal(dec2.pack(), system.decoder.pack())
                 and torch.equal(state2.attr_rows[:after, :10], system.state.attr_rows[:after, :10]))
    # the scene's surfaces within the sensor's reach of the trajectory
    traj = np.stack(ds.odom_poses)[:, :3, 3]
    near = np.zeros(len(world), bool)
    for c in traj[::4]:
        near |= np.linalg.norm(world - c, axis=1) < cfg.max_range
    ev = eval_mesh(verts, faces, world[near], threshold=2 * cfg.mc_res_m) if len(verts) else {}
    res = {
        "phase": f"mesh_{name}", "mc_res_m": cfg.mc_res_m, "mesh_min_nn": cfg.mesh_min_nn,
        "query_bucket": cfg.mesh_query_bucket, "device": str(system.device),
        "map_points_before": before, "map_points_after": after,
        "finalize_ms": t["finalize_ms"], "chunks": len(view_counts),
        "view_counts": view_counts, "local_capacity": system.mc.local_capacity,
        "query_buckets": main["buckets"], "grid_points": main["points"],
        "grid_query_ms": main["query_ms"],
        "grid_points_per_s": main["points"] / max(main["query_ms"], 1e-9) * 1e3,
        "extract_numpy_ms": main["numpy_ms"],
        "native": native_status, "native_reason": native_reason,
        "extract_native_ms": main["native_ms"] if native_status == "built" else None,
        "native_vs_numpy": parity if native_status == "built" else None,
        "save_artifacts_s": save_s, "vertices": int(len(verts)), "faces": int(len(faces)),
        "mesh_xy_span_m": span_mesh.tolist(), "map_xy_span_m": span_pts.tolist(),
        "fscore": ev.get("fscore"), "fscore_threshold_m": 2 * cfg.mc_res_m,
        "chamfer_l1_m": ev.get("chamfer_l1"), "precision": ev.get("precision"),
        "recall": ev.get("recall"), "gt_points": int(near.sum()),
        "ate_rmse_m": metrics.get("ate_rmse_m"), "ate_rot_deg": metrics.get("ate_rot_deg"),
        "ate_rmse_unaligned_m": absolute_error(ds.gt_poses, np.stack(ds.odom_poses),
                                               align=False)[0],
        "map_reloads": reload_ok, "files": files,
        "max_memory_allocated_gb": peak_gb, "multi_chunk": multi,
    }
    emit(res)
    shutil.rmtree(run_dir, ignore_errors=True)
    if not len(verts) or not len(faces):
        fail(f"mesh {name}: empty mesh")
    if not np.isfinite(verts).all():
        fail(f"mesh {name}: non-finite vertices")
    if not (span_mesh >= 0.8 * span_pts).all():
        fail(f"mesh {name}: mesh xy span {span_mesh} m < 0.8 of the map's {span_pts} m")
    if max(view_counts, default=0) >= system.mc.local_capacity:
        fail(f"mesh {name}: a chunk's view overflows {system.mc.local_capacity}: {view_counts}")
    if multi is not None:
        if multi["chunks"] < 2 or multi["max_view_count"] >= multi["local_capacity"]:
            fail(f"mesh {name}: the multi-chunk mesh took {multi['chunks']} chunks, views "
                 f"up to {multi['max_view_count']} of {multi['local_capacity']}")
        if not (np.array(multi["mesh_xy_span_m"]) >= 0.8 * span_pts).all():
            fail(f"mesh {name}: multi-chunk mesh xy span {multi['mesh_xy_span_m']} m "
                 f"< 0.8 of the map's {span_pts} m")
        ch = multi["chamfer_to_one_chunk_m"]
        if not multi["finite"] or ch is None or ch > MULTI_CHAMFER_FRAC * cfg.mc_res_m:
            fail(f"mesh {name}: the multi-chunk mesh differs from the one-chunk mesh: {multi}")
        if not multi["overflow_view_equal_cpu"]:
            fail(f"mesh {name}: an overflowing view on the card differs from the CPU's")
    if not reload_ok:
        fail(f"mesh {name}: pin_map.npz does not reload to the finalised map and decoder")
    if after <= 0 or after > before:
        fail(f"mesh {name}: finalize_map left {after} of {before} points")
    if native_status == "built" and (parity["max_vert_diff"] > NATIVE_VERTS
                                     or parity["max_face_diff"] > NATIVE_FACES
                                     or parity["max_chamfer"] >= NATIVE_CHAMFER):
        fail(f"mesh {name}: native and numpy extraction disagree: {parity}")
    missing = {"map/pin_map.npz", "map/neural_points.ply", "mesh/mesh.ply",
               "odom_poses_kitti.txt", "odom_poses_tum.txt", "pose_eval.csv",
               "time_table.npy"} - set(files)
    if ds.total_pc_count > 0:
        missing |= {"map/merged_point_cloud.ply"} - set(files)
    if missing:
        fail(f"mesh {name}: artifacts missing: {sorted(missing)}")
    return res


# ----------------------------------------------------------------------
# kernel phases
# ----------------------------------------------------------------------


def time_ms(fn):
    """Event time of one call on an idle card (median of TIMED): the call's
    device time plus the host's launch path, which the card waits for."""
    import torch

    for _ in range(3):
        fn()
    ts = []
    for _ in range(TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def device_ms(fn, reps=DEVICE_REPS):
    """Device time of one call: ``reps`` calls queued behind ``torch.cuda._sleep``
    between two events, so the card runs them back to back and the host's
    launch path is hidden; ms / reps, the median of three batches.  The sleep
    lasts three times the host's wall time of ``reps`` synchronised calls.  A
    batch whose first event the card reached before the host had queued
    every call (the launch queue filled) is retried with half the calls.
    Returns (ms, hidden): ``hidden`` is False when even one call could not be
    queued ahead, i.e. the figure still holds host time (a call that waits
    on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(max((time.perf_counter() - t0) * reps * 3, 1e-3) * SLEEP_CYCLES_PER_S)
    ts, hidden = [], True
    while len(ts) < 3:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        early = a.query()
        b.synchronize()
        if early and reps > 1:
            reps //= 2
            continue
        hidden = hidden and not early
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts)), hidden


def timings(kernel, plain, library=None):
    """The row's event and device times of the kernel, its plain version and
    the library call (None where there is none)."""
    out, exposed = {}, []
    for key, fn, reps in (("", kernel, DEVICE_REPS), ("plain_", plain, PLAIN_REPS),
                          ("library_", library, DEVICE_REPS)):
        if fn is None:
            out[f"{key}ms"] = out[f"{key}device_ms"] = None
            continue
        out[f"{key}ms"] = time_ms(fn)
        out[f"{key}device_ms"], hidden = device_ms(fn, reps)
        if not hidden:
            exposed.append(key.rstrip("_") or "kernel")
    if exposed:
        out["device_ms_holds_host_time"] = exposed
    return out


def identical_check(a, b, label):
    """Fails unless two launches' outputs (a tensor or a tuple of them) are
    bit-identical."""
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    for i, (x, y) in enumerate(zip(a, b)):
        bits = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in (x, y)]
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(*bits):
            fail(f"{label}: two launches differ in output {i}")


def bound(nbytes, flops):
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rank_check(out_k, out_p, label):
    """Fails unless the rank kernel's (gidx, pos, valid) equal the plain
    version's exactly."""
    import torch

    for i, what in ((0, "gidx"), (2, "valid"), (1, "pos")):
        a, b = out_k[i], out_p[i].to(out_k[i].dtype)
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else -1
            fail(f"rank kernel {label}: {what} differs from the plain version ({bad} values)")


def rank_bound(G, n, K, k, cand_floats=None):
    """The ranking's least time: the candidate floats read once (by default
    the 5 K of each group's gathered field-major row), the queries and the
    outputs (17 bytes a neighbour); 9 operations per (query, candidate)."""
    cand = 5 * G * K if cand_floats is None else cand_floats
    return bound(4 * (cand + 3 * G * n) + G * n * k * 17, G * n * K * 9)


def rank_brick_bounds(args):
    """(bound_ms, bound_by, rows_fm_bound_ms, distinct rows) of the fused
    brick probe + rank on its inputs.  The function must read each distinct
    table row that its groups hash to once (neighbouring groups share bricks:
    their re-reads are cache traffic, not memory traffic), the probe points,
    the template and the queries, and write the outputs.  ``rows_fm_bound_ms``
    charges every group its own Kb rows instead, as the unfused pipeline's
    field-major rows held them: the rank rows' earlier bound, kept for
    comparison."""
    import torch

    from pin_slam_torch.ops.hash3d import grid_coords, spatial_hash

    _, bricks, memb, probe, queries, k, _, _, voxel, brick, Hb = args
    G, n = queries.shape[0], queries.shape[1]
    nsub, Kb = bricks.shape[0], bricks.shape[1]
    bvec = torch.tensor(brick, dtype=torch.int32, device=probe.device)
    gc = grid_coords(probe, voxel)
    bc = torch.div(gc, bvec, rounding_mode="floor")
    par = (gc - bc * bvec).long()
    bidx = (par[:, 0] * brick[1] + par[:, 1]) * brick[2] + par[:, 2]
    distinct = int(torch.unique(spatial_hash(bc[:, None, :] + bricks[bidx], Hb)).numel())
    fixed = 3 * G + bricks.numel() + memb.numel()
    b, by = rank_bound(G, n, Kb * nsub, k, 5 * nsub * distinct + fixed)
    rows_fm_b, _ = rank_bound(G, n, Kb * nsub, k, 5 * G * Kb * nsub + 3 * G)
    return b, by, rows_fm_b, distinct


def rank_brick_phase(label, args, launches):
    """The fused brick probe + rank on a captured input: exact against its
    plain version (the torch brick gather, then the plain ranking), two
    launches bit-identical, timed beside the plain version."""
    from pin_slam_torch.ops import rank_kernel as rk

    bricks, queries, k, Hb = args[1], args[4], args[5], args[10]
    G, n = queries.shape[0], queries.shape[1]
    Kb, nsub = bricks.shape[1], bricks.shape[0]
    Kc = Kb * nsub
    out_k = launched_twice(rk.probe_rank_brick, args, f"rank_brick kernel {label}")
    rank_check(out_k, rk.probe_rank_brick_plain(*args), label)
    t = timings(lambda: rk.probe_rank_brick(*args), lambda: rk.probe_rank_brick_plain(*args))
    b, by, rows_fm_b, distinct = rank_brick_bounds(args)
    row = {"name": f"rank_brick[{label}]", "route": "cuda",
           "source": "pin_slam_torch/csrc/rank.cu",
           "replaces": "pin_slam_tpu/ops/rank_kernel.py:105", "launches": launches,
           "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
           "rows_fm_bound_ms": rows_fm_b,
           "shape": {"G": G, "n": n, "Kb": Kb, "nsub": nsub, "Kc": Kc, "k": k, "Hb": Hb,
                     "distinct_rows": distinct},
           "check": "gidx/valid/pos exact against the plain version; two launches "
                    "bit-identical"}
    emit({"phase": "kernel", **row})
    return row


def rank_table(Hb, L, seed, brick=(2, 2, 1)):
    """A random brick-layout local hash: L points on a 1/8 m lattice in
    [-8, 8)^3, a tenth of them duplicated (exact distance ties), packed into
    Hb brick rows (many collisions).  Returns (MapConfig, table, points)."""
    import torch

    from pin_slam_torch.models import neural_points as npts

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.floor((torch.rand(L + 1, 3, generator=g, device="cuda") * 16 - 8) * 8) / 8
    pts[1:L // 10] = pts[L // 2:L // 2 + L // 10 - 1]
    mc = npts.MapConfig(capacity=1 << 20, local_capacity=L, hash_size=1 << 10,
                        voxel_size=0.4, feature_dim=8, nn_k=6, max_valid_dist2=1.0,
                        local_map_radius=10.0, travel_dist_window=50.0,
                        local_hash_size=Hb * brick[0] * brick[1] * brick[2], brick=brick)
    idx = torch.randint(0, 1 << 20, (L + 1,), generator=g, device="cuda")
    table = npts._pack_hash_rows(mc, pts, torch.tensor(L, device="cuda"), idx)
    return mc, table, pts


def rank_probes(pts, G, seed):
    """G probe points within 0.2 m of random map points; a quarter of them
    moved 20 m towards negative coordinates, off the map, and the last eighth
    at the dedup filler 1e6."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.randint(0, pts.shape[0] - 1, (G,), generator=g, device="cuda")
    probe = pts[pick] + (torch.rand(G, 3, generator=g, device="cuda") - 0.5) * 0.4
    probe[: G // 4] -= 20.0
    probe[G - G // 8:] = 1e6
    return probe


def rank_edge_phase():
    """The fused kernel at G in {0, 1, 37} x n in {1, 4, 5} x k in {1, 6, 16}
    on random tables with both paths' candidate counts (Kc 64 and 128: the
    default and run_kitti.yaml templates on a (2, 2, 1) brick), negative
    probes and probes at 1e6, and its scalar-load instantiation (on a table
    view 4 bytes off alignment, and on a (2, 1, 1) brick, whose 40-byte rows
    are no float4 rows) at G 37, n 1 / 5, k 6; the per-cell kernel at the
    same G, n, k as the first on random field-major rows with K 33 and 81.
    Each exact against its plain version and two launches bit-identical;
    G = 0 launches nothing.  Not a main-path shape, so kept out of the
    kernels line."""
    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import rank_kernel as rk

    cases = 0
    mc, table, pts = rank_table(4096, 4096, 0)
    for nei, alpha in ((2, 0.2), (2, 0.5)):
        tmpl = npts.make_probe_template(mc, nei, alpha, device="cuda")
        for G in (0, 1, 37):
            probe = rank_probes(pts, G, 10 + G)
            for n in (1, 4, 5):
                q = probe[:, None, :] + torch.linspace(-0.3, 0.3, n, device="cuda")[None, :, None]
                for k in (1, 6, 16):
                    args = (table, tmpl.bricks, tmpl.memb, probe, q, k, mc.local_capacity,
                            mc.max_valid_dist2, mc.voxel_size, mc.brick, mc.brick_rows)
                    label = f"edge G={G} n={n} k={k} Kc={tmpl.memb.shape[1]}"
                    before = _cuda.COUNTS["rank_brick"]
                    out = launched_twice(rk.probe_rank_brick, args, label)
                    if G == 0 and _cuda.COUNTS["rank_brick"] != before:
                        fail(f"rank_brick kernel {label}: launched at G = 0")
                    rank_check(out, rk.probe_rank_brick_plain(*args), label)
                    cases += 1
    off = torch.empty(table.numel() + 1, device="cuda")[1:].view_as(table)
    off.copy_(table)
    mc2, table2, pts2 = rank_table(4096, 4096, 1, brick=(2, 1, 1))
    for name, (m, tab, p) in {"off4": (mc, off, pts), "brick211": (mc2, table2, pts2)}.items():
        for nei, alpha in ((2, 0.2), (2, 0.5)):
            tmpl = npts.make_probe_template(m, nei, alpha, device="cuda")
            probe = rank_probes(p, 37, 5)
            for n in (1, 5):
                q = probe[:, None, :] + torch.linspace(-0.3, 0.3, n, device="cuda")[None, :, None]
                args = (tab, tmpl.bricks, tmpl.memb, probe, q, 6, m.local_capacity,
                        m.max_valid_dist2, m.voxel_size, m.brick, m.brick_rows)
                label = f"edge {name} n={n} Kc={tmpl.memb.shape[1]}"
                rank_check(launched_twice(rk.probe_rank_brick, args, label),
                           rk.probe_rank_brick_plain(*args), label)
                cases += 1
    for K in (33, 81):
        for G in (0, 1, 37):
            for n in (1, 4, 5):
                for k in (1, 6, 16):
                    rows, q = rank_cell_inputs(G, n, K, 4096, 20 + G + n)
                    args = (rows, q, k, 4096, 1.0)
                    label = f"per-cell edge G={G} n={n} k={k} K={K}"
                    out = launched_twice(rk.probe_rank, args, label)
                    rank_check(out, rk.probe_rank_plain(*args), label)
                    cases += 1
    emit({"phase": "rank_edges", "cases": cases,
          "check": "gidx/valid/pos exact against the plain version; two launches "
                   "bit-identical; no launch at G = 0"})


def rank_cell_inputs(G, n, K, L, seed):
    """Field-major candidate rows on a coarse lattice (exact distance ties),
    a share of invalid local indices, a quarter of the balls with at most 3
    valid candidates, and queries on the same lattice."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = lambda *s: torch.round((torch.rand(*s, generator=g, device="cuda") * 2 - 1) * 4) / 4
    lidx = torch.randint(0, L + L // 3, (G, 1, K), generator=g, device="cuda").float()
    lidx[: G // 4, :, 3:] = L
    gidx = torch.randint(0, 1 << 22, (G, 1, K), generator=g, device="cuda").float()
    rows = torch.cat([lat(G, 3, K), lidx, gidx], 1).reshape(G, 5 * K)
    return rows, lat(G, n, 3)


def rank_cells_phase():
    """The per-cell layout's rank kernel (no main path uses it; the brick
    layout is on in every path) on random field-major rows at path B's near
    shape with the per-cell template of run_kitti.yaml (K = 81): exact
    against its plain version, two launches bit-identical, timed.  Kept out
    of the kernels line."""
    from pin_slam_torch.ops import rank_kernel as rk

    G, n, K, k, L = 65536, 5, 81, 6, 1 << 18
    rows, q = rank_cell_inputs(G, n, K, L, 3)
    args = (rows, q, k, L, 1.0)
    out_k = launched_twice(rk.probe_rank, args, "rank kernel per-cell")
    rank_check(out_k, rk.probe_rank_plain(*args), "per-cell")
    t = timings(lambda: rk.probe_rank(*args), lambda: rk.probe_rank_plain(*args))
    b, by = rank_bound(G, n, K, k)
    emit({"phase": "rank_cells", "name": "rank[per-cell random]", "route": "cuda",
          "source": "pin_slam_torch/csrc/rank.cu",
          "replaces": "pin_slam_tpu/ops/rank_kernel.py:105", "launches": 0,
          "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
          "shape": {"G": G, "n": n, "K": K, "k": k},
          "check": "gidx/valid/pos exact; two launches bit-identical"})


def _parts(out, IN):
    """(name, tensor, relative tolerance) of each separately scaled part of
    a training kernel's (loss, dfeats, dparams) at IN decoder inputs."""
    loss, dfeats, dparams = out
    F = dfeats.shape[-1] - 1
    H = (dparams.shape[0] - 1) // (IN + 2)
    cuts = np.cumsum([0, IN * H, H, H, 1])
    leaves = [(n, dparams[a:b], TOL_REL, True) for n, a, b in
              zip(("dW1", "db1", "dW2", "db2"), cuts[:-1], cuts[1:])]
    return [("loss", loss.reshape(1), TOL_REL, False),
            ("dfeats", dfeats[..., :F], TOL_REL, False),
            ("certainty", dfeats[..., F], TOL_CERT, False)] + leaves


CHECK_TEXT = (f"vs the plain version in float64, each of loss, dfeats, certainty, dW1, db1, "
              f"dW2, db2 within {TOL_REL} x its max ({TOL_CERT} for certainty); a decoder "
              f"leaf also passes within {DEC_ULPS} ulps of the largest decoder gradient; a part "
              f"outside is held again, at the same tolerance, to the float64 version with the "
              f"float32 version's ReLU masks (a pre-activation within float32 rounding of 0)")


def _aligned_plain(plain, args):
    """``plain(*args)`` in float64 with the ReLU masks of its float32 run on
    the same inputs, and the number of hidden units whose mask the float64
    pre-activations would flip.  A pre-activation within float32 rounding of
    0 can take the other side of the ReLU in float64 (the inputs'
    conditioning, which the float32 plain version shows as well); with the
    float32 masks the float64 run measures the arithmetic alone."""
    import torch

    from pin_slam_torch.ops import train_kernel as tk

    orig, masks, flips = tk._mlp, [], [0]

    def record(x, W1, b1, W2, b2):
        masks.append(x @ W1 + b1 > 0)
        return orig(x, W1, b1, W2, b2)

    def replay(x, W1, b1, W2, b2):
        z = x @ W1 + b1
        m = masks.pop(0)
        flips[0] += int(((z > 0) != m).sum())
        return ((z * m) @ W2)[..., 0] + b2[0]

    try:
        tk._mlp = record
        plain(*args)
        tk._mlp = replay
        out = plain(*[a.double() if isinstance(a, torch.Tensor) else a for a in args])
    finally:
        tk._mlp = orig
    return out, flips[0]


def _cmp(out_k, plain, args, label):
    """Holds a training kernel's outputs ``out_k`` against ``plain(*args)`` in
    float32 (P) and in float64 (T), part by part (see TOL_REL above); a part
    out of tolerance is held again to T with P's ReLU masks
    (``_aligned_plain``).  Returns (max |kernel - P| over the parts, {part:
    [|kernel - T|, |P - T|, max|T|] (+ [|kernel - T with P's masks|])}, and
    the masks' flips where that ran); fails if a part is out of tolerance
    both ways."""
    import torch

    F, _, vd, _ = widths(args)
    out_p = plain(*args)
    out_t = plain(*[a.double() if isinstance(a, torch.Tensor) else a for a in args])
    dec_floor = DEC_ULPS * 2.0 ** -23 * float(out_t[2].abs().max())
    aligned = None
    errs, detail = [], {}
    for i, ((what, k, tol, dec), (_, p, _, _), (_, t, _, _)) in enumerate(zip(
            _parts(out_k, F + vd), _parts(out_p, F + vd), _parts(out_t, F + vd))):
        e_k = float((k.double() - t).abs().max())
        e_p = float((p.double() - t).abs().max())
        scale = float(t.abs().max())
        detail[what] = [e_k, e_p, scale]
        if not (e_k <= tol * scale or (dec and e_k <= dec_floor)):
            if aligned is None:
                out_a, flips = _aligned_plain(plain, args)
                aligned = _parts(out_a, F + vd)
                detail["mask_flips"] = flips
            t_a = aligned[i][1]
            e_a = float((k.double() - t_a).abs().max())
            scale_a = float(t_a.abs().max())
            detail[what].append(e_a)
            if not (e_a <= tol * scale_a or (dec and e_a <= dec_floor)):
                fail(f"{label}: {what} max err {e_k:.3e} vs float64 (the plain version's own "
                     f"{e_p:.3e}) > {tol} x {scale:.3e}"
                     + (f" and > {dec_floor:.3e} ({DEC_ULPS} ulps of the largest decoder "
                        f"gradient)" if dec else "")
                     + f"; {e_a:.3e} with the float32 ReLU masks ({detail['mask_flips']} "
                       f"flips)")
        errs.append(float((k - p).abs().max()))
    return max(errs), detail


def decodes(wf, rows, k, per_row):
    return rows * per_row * (1 if wf else k)


def widths(args):
    """(F, H, VD, k) of a training kernel's arguments (the train kernel's
    nine or the eikonal kernel's eight)."""
    from pin_slam_torch.ops import train_kernel as tk

    train = len(args) == 9
    feats, vcols = args[0], args[2].shape[1]
    params, wf = (args[5], args[6]) if train else (args[4], args[5])
    k, F = feats.shape[1], feats.shape[2] - 1
    vd = vcols if wf else vcols // k
    return F, tk.hidden_width(params.shape[0], F, vd), vd, k


def decode_flops(F, H, vd):
    """Float32 operations one decode of a training kernel needs at F
    features, H hidden units and offset width ``vd`` (IN = F + vd inputs):
    the forward (IN x H FMAs, H bias adds, H FMAs into the output), dh (H),
    the input gradient of the F feature columns only (F x H FMAs: the offset
    vectors take none), and the decoder-gradient sums (IN x H + H FMAs, H
    adds)."""
    IN = F + vd
    return (2 * IN * H + 3 * H) + H + 2 * F * H + (2 * IN * H + 3 * H)


def train_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import train_kernel as tk

    feats, w, vin, label_t, wt, params, wf, scale, sigma = args
    B, k = w.shape
    F, H, vd, _ = widths(args)
    out_k = launched_twice(tk.train_iter, args, f"train_iter kernel {label}")
    err, detail = _cmp(out_k, tk.train_iter_plain, args, f"train_iter kernel {label}")
    t = timings(lambda: tk.train_iter(*args), lambda: tk.train_iter_plain(*args))
    flops = decodes(wf, B, k, decode_flops(F, H, vd)) + (2 * B * k * F if wf else 2 * B * k)
    b, by = bound(nbytes(feats, w, vin, label_t, wt, params, out_k[1], out_k[2]) + 4, flops)
    row = {"name": f"train_iter[{label}]", "route": "cuda",
           "source": "pin_slam_torch/csrc/train_iter.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:247", "launches": launches,
           "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
           "shape": {"B": B, "k": k, "F": F, "H": H, "VD": vd, "weighted_first": wf},
           "launch": train_launch(B, k, wf, feats.get_device(), vd, F, H),
           "check": CHECK_TEXT + "; two launches bit-identical", "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


def general_launch_info(kernel, n, k, wf, device, vd, F, H):
    """A general-form launch of ``kernel`` at (n, k, mode, F, H, VD): the
    build that runs (a width class, or the tiled form with its plan), rows
    per group, groups, blocks, threads, blocks per SM."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    R, blocks, resident = tk.general_launch(kernel, device, n, k, F, H, vd, wf)
    form = tk.general_form(F, H, vd)
    info = {"form": form, "rows_per_group": R, "groups": -(-n // R), "blocks": blocks,
            "threads": tk.GEN_THREADS, "blocks_per_sm": resident // _cuda.sm_count(device)}
    if form == "class":
        info["width"] = tk.general_width(vd)
    else:
        res, dc, dmax, floats = tk.tiled_plan(F, H, vd, k, bool(wf), kernel == "eikonal")
        info["plan"] = {"w1_resident": bool(res), "chunk_decodes": dc, "group_decodes": dmax,
                        "smem_kb": floats * 4 / 1024}
    return info


def train_launch(B, k, wf, device, vd=3, F=8, H=64):
    """The train kernel's launch at (B, k, mode) on ``device``: rows per
    block, blocks, threads per block, the blocks per SM its build allows
    and, for the general forms (any width but F 8, H 64, VD 3),
    ``general_launch_info``."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    if tk.general_form(F, H, vd) != "dedicated":
        return general_launch_info("train_iter", B, k, wf, device, vd, F, H)
    sms = _cuda.sm_count(device)
    resident = tk.train_resident_blocks(device, bool(wf))
    R = tk.train_rows_per_block(B, k, bool(wf), resident)
    return {"rows_per_block": R, "blocks": -(-B // R), "threads": tk.TRAIN_THREADS,
            "blocks_per_sm": resident // sms}


def eik_launch(n, k, wf, device, vd=3, F=8, H=64):
    """The eikonal kernel's launch at (n, k, mode) on ``device``, as
    ``train_launch`` (the dedicated build sizes R from the SM count alone)."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    if tk.general_form(F, H, vd) != "dedicated":
        return general_launch_info("eikonal", n, k, wf, device, vd, F, H)
    R = tk.eikonal_rows_per_block(n, k, bool(wf), _cuda.sm_count(device))
    return {"form": "VD=3", "rows_per_block": R, "blocks": -(-n // R), "threads": 256}


def launched_twice(fn, args, label):
    """``fn(*args)`` twice; fails unless the two outputs are bit-identical.
    Returns the first."""
    import torch

    out1 = fn(*args)
    out2 = fn(*args)
    if out1[1].is_cuda:
        torch.cuda.synchronize()
    identical_check(out1, out2, label)
    return out1


def eik_phase(label, args, kwargs, launches):
    from pin_slam_torch.ops import train_kernel as tk

    feats, wst, vst, esc, params, wf, scale, step = args
    n, k = feats.shape[0], feats.shape[1]
    F, H, vd, _ = widths(args)
    out_k = launched_twice(tk.eikonal_iter, args, f"eikonal kernel {label}")
    err, detail = _cmp(out_k, tk.eikonal_iter_plain, args, f"eikonal kernel {label}")
    t = timings(lambda: tk.eikonal_iter(*args), lambda: tk.eikonal_iter_plain(*args))
    flops = decodes(wf, n, k, 6 * decode_flops(F, H, vd))
    b, by = bound(nbytes(feats, wst, vst, esc, params, out_k[1], out_k[2]) + 4, flops)
    row = {"name": f"eikonal[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/eikonal.cu",
           "replaces": "pin_slam_tpu/ops/train_kernel.py:471", "launches": launches,
           "max_abs_err": err, **t, "bound_ms": b, "bound_by": by,
           "shape": {"n": n, "k": k, "F": F, "H": H, "VD": vd, "weighted_first": wf},
           "launch": eik_launch(n, k, wf, feats.get_device(), vd, F, H),
           "check": CHECK_TEXT + "; two launches bit-identical", "err_vs_f64": detail}
    emit({"phase": "kernel", **row})
    return row


EDGE_VDS = (3, 15, 27, 35, 64)     # no encoding, NeRF bands 2 and 4, Gaussian 16, the widest
EDGE_KS = (1, 6, 8, 16)
# the tiled form (F, H, VD): narrow, wide features, wide hidden layers, the
# offset widths past the width classes (Gaussian 31 bands, NeRF 11 and 20),
# and the widest the predicate takes (NeRF band 32); at rows that are no
# multiple of any tile
EDGE_WIDTHS = ((4, 32, 3), (16, 64, 3), (16, 128, 27), (32, 256, 3), (8, 64, 65), (8, 64, 69),
               (8, 64, 123), (64, 256, 195))
EDGE_WIDE_B, EDGE_WIDE_N = (1, 37, 4099), (1, 37, 1001)


def train_edge_phase():
    """The train kernel on dyadic inputs at B in {1, 37, 16384} x k in
    {1, 6, 8, 16} x VD in ``EDGE_VDS`` x both modes: two launches
    bit-identical, and part by part against the plain version in float64
    at the stated tolerances; at B = 0 no launch and zero sums.  Not a
    main-path shape, so kept out of the kernels line."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import train_kernel as tk

    errs, cases = {}, 0
    for vd in EDGE_VDS:
        for wf in (True, False):
            for k in EDGE_KS:
                args = synthetic_train_args(wf, 0, k, 0, vd=vd)
                before = _cuda.COUNTS["train_iter"]
                loss, dfeats, dparams = tk.train_iter(*args)
                if (_cuda.COUNTS["train_iter"] != before or dfeats.shape != (0, k, 9)
                        or float(loss) != 0.0 or bool(dparams.any())
                        or dparams.shape != (tk.n_params(vd),)):
                    fail(f"train_iter kernel edge B=0 k={k} VD={vd} wf={int(wf)}: launched, "
                         f"or not zero")
                cases += 1
                for B in (1, 37, 16384):
                    label = f"train_iter kernel edge B={B} k={k} VD={vd} wf={int(wf)}"
                    args = synthetic_train_args(wf, B, k, 200 + 10 * B + k + 1000 * vd,
                                                dyadic=True, vd=vd)
                    err, _ = _cmp(launched_twice(tk.train_iter, args, label),
                                  tk.train_iter_plain, args, label)
                    errs[vd] = max(errs.get(vd, 0.0), err)
                    cases += 1
    emit({"phase": "train_edges", "cases": cases, "max_abs_err_vs_plain_by_vd": errs,
          "check": CHECK_TEXT + "; two launches bit-identical"})


def eikonal_edge_phase():
    """The eikonal kernel on dyadic inputs at n in {1, 37, 1638} x k in
    {1, 6, 8, 16} x VD in ``EDGE_VDS`` x both modes: two launches
    bit-identical, and part by part against the plain version in float64 at
    the stated tolerances.  Not a main-path shape, so kept out of the
    kernels line."""
    from pin_slam_torch.ops import train_kernel as tk

    errs, cases = {}, 0
    for vd in EDGE_VDS:
        for wf in (True, False):
            for k in EDGE_KS:
                for n in (1, 37, 1638):
                    label = f"eikonal kernel edge n={n} k={k} VD={vd} wf={int(wf)}"
                    args = synthetic_eik_args(wf, n, k, 100 + 10 * n + k + 1000 * vd,
                                              dyadic=True, vd=vd)
                    err, _ = _cmp(launched_twice(tk.eikonal_iter, args, label),
                                  tk.eikonal_iter_plain, args, label)
                    errs[vd] = max(errs.get(vd, 0.0), err)
                    cases += 1
    emit({"phase": "eikonal_edges", "cases": cases, "max_abs_err_vs_plain_by_vd": errs,
          "check": CHECK_TEXT + "; two launches bit-identical"})


def width_edge_phase():
    """Both training kernels at every (F, H, VD) of ``EDGE_WIDTHS`` x k in
    ``EDGE_KS`` x both modes, on dyadic inputs, at B in ``EDGE_WIDE_B`` (train)
    and n in ``EDGE_WIDE_N`` (eikonal): ``kernels_take`` holds each, two
    launches bit-identical, and part by part against the plain version in
    float64 at the stated tolerances.  Kept out of the kernels line."""
    from pin_slam_torch.ops import train_kernel as tk

    errs, plans, cases = {}, {}, 0
    for F, H, vd in EDGE_WIDTHS:
        for k in EDGE_KS:
            if not tk.kernels_take(F, H, vd, k):
                fail(f"kernels_take refuses the edge width F={F} H={H} VD={vd} k={k}")
            for wf in (True, False):
                for kernel, fn, plain, make, sizes in (
                        ("train_iter", tk.train_iter, tk.train_iter_plain, synthetic_train_args,
                         EDGE_WIDE_B),
                        ("eikonal", tk.eikonal_iter, tk.eikonal_iter_plain, synthetic_eik_args,
                         EDGE_WIDE_N)):
                    plans[f"{kernel} F={F} H={H} VD={vd} k={k} wf={int(wf)}"] = \
                        tk.tiled_plan(F, H, vd, k, wf, kernel == "eikonal")
                    for n in sizes:
                        label = f"{kernel} kernel width edge n={n} k={k} F={F} H={H} VD={vd} " \
                                f"wf={int(wf)}"
                        args = make(wf, n, k, 300 + 10 * n + k + 1000 * vd + F + H, dyadic=True,
                                    vd=vd, F=F, H=H)
                        err, _ = _cmp(launched_twice(fn, args, label), plain, args, label)
                        key = f"F={F} H={H} VD={vd}"
                        errs[key] = max(errs.get(key, 0.0), err)
                        cases += 1
    emit({"phase": "width_edges", "cases": cases, "max_abs_err_vs_plain_by_width": errs,
          "tiled_plans": plans, "check": CHECK_TEXT + "; two launches bit-identical"})


def gather_edge_phase():
    """The row gather at C in {1, 9, 24, 42} x M in {0, 1, 98304}, on an
    aligned table and on views 4 and 8 bytes off alignment (the vector
    widths' fallbacks), and once on a table of more than 2^31 floats (64-bit
    offsets); each bit-exact against ``table[idx]``.  Kept out of the kernels
    line."""
    import torch

    from pin_slam_torch.ops import rows

    g = torch.Generator(device="cuda").manual_seed(11)
    N, cases = 65537, 0
    for C in (1, 9, 24, 42):
        buf = torch.randn(N * C + 2, generator=g, device="cuda")
        tables = {"aligned": buf[:N * C].view(N, C), "off4": buf[1:1 + N * C].view(N, C),
                  "off8": buf[2:2 + N * C].view(N, C)}
        for M in (0, 1, 98304):
            idx = torch.randint(0, N, (M,), generator=g, device="cuda")
            if M > 1:
                idx[:2] = torch.tensor([0, N - 1], device="cuda")
            for name, tab in tables.items():
                out = rows.gather_rows(tab, idx)
                torch.cuda.synchronize()
                gather_check(out, tab, idx, f"edge C={C} M={M} {name}")
                cases += 1
    C = 42
    N = (1 << 31) // C + 4096
    big = torch.randn(N, C, generator=g, device="cuda")
    idx = torch.randint(0, N, (98304,), generator=g, device="cuda")
    idx[:2] = torch.tensor([N - 1, N - 4096], device="cuda")
    out = rows.gather_rows(big, idx)
    torch.cuda.synchronize()
    gather_check(out, big, idx, f"edge C={C} N={N} (64-bit offsets)")
    del big, out
    torch.cuda.empty_cache()
    emit({"phase": "gather_edges", "cases": cases + 1, "check": "bit-exact against table[idx]"})


def gather_check(out, table, idx, label):
    """Fails unless a gather's result equals ``table[idx]`` bit for bit."""
    import torch

    from pin_slam_torch.ops import rows

    ref = rows.gather_rows_plain(table, idx)
    if out.shape != ref.shape or not torch.equal(out, ref):
        bad = int((out != ref).any(1).sum()) if out.shape == ref.shape else -1
        fail(f"gather kernel {label}: {bad} rows differ from table[idx]")


def gather_phase(label, args, kwargs, launches):
    """The row gather on a captured input: exact against ``table[idx]``;
    timed as the kernel alone (the wrapper's range check, one host sync, is
    done once per frame on the main path), the plain version and
    ``torch.index_select``."""
    import torch

    from pin_slam_torch.ops import rows

    table, idx = args[0], args[1]
    M, C = idx.shape[0], table.shape[1]
    out_k = rows.gather_rows(table, idx)
    torch.cuda.synchronize()
    gather_check(out_k, table, idx, label)
    t = timings(lambda: rows.gather_rows(table, idx, bounds_checked=True),
                lambda: rows.gather_rows_plain(table, idx),
                lambda: torch.index_select(table, 0, idx))
    b, by = bound(nbytes(idx, out_k) + M * C * 4, 0)
    row = {"name": f"gather[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:43", "launches": launches,
           "max_abs_err": 0.0, **t, "bound_ms": b, "bound_by": by,
           "shape": {"N": table.shape[0], "C": C, "M": M,
                     "table_16B_aligned": table.data_ptr() % 16 == 0},
           "check": "bit-exact against table[idx]"}
    emit({"phase": "kernel", **row})
    return row


def scatter_check(out, table, idx, val, skip_row):
    """Holds a scatter's result against the float64 sum, element by element,
    to the recursive-summation bound (see SCATTER_ULP).  Returns the largest
    |error| and the largest error/bound ratio; fails past the bound."""
    import torch

    keep = idx != skip_row if skip_row is not None else torch.ones_like(idx, dtype=torch.bool)
    i, v = idx[keep], val[keep].double()
    exact = table.double().index_add(0, i, v)
    mag = table.double().abs().index_add(0, i, v.abs())
    n = torch.bincount(i, minlength=table.shape[0]).double()[:, None]
    err = (out.double() - exact).abs()
    lim = (n + 1.0) * SCATTER_ULP * mag
    ratio = float((err / torch.clamp(lim, min=1e-300)).max())
    if bool((err > lim).any()):
        bad = int((err > lim).any(1).sum())
        fail(f"scatter: {bad} rows beyond n * 2^-24 * sum|terms| of the float64 sum "
             f"(max err {float(err.max()):.3e})")
    return float(err.max()), ratio


def ordered_check(out, ref, label):
    """Fails unless a scatter's result has the bits of
    ``rows.scatter_add_rows_ordered`` (a sequential in-order index_add's)."""
    import torch

    a, b = (t.contiguous().view(torch.int32) for t in (out, ref))
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(a, b):
        bad = int((a != b).sum()) if out.shape == ref.shape else -1
        fail(f"scatter kernel {label}: {bad} elements differ from the in-order sum's bits")


def scatter_forms(n_rows, idx, val, plan, skip, table, label):
    """Both forms of the scatter kernel on one input, the zero-base form and
    the table form onto ``table``: each twice (bit-identical), each with the
    bits of ``scatter_add_rows_ordered`` and within the float64 bound.
    Returns (zero-base output, max error vs float64, max error/bound)."""
    import torch

    from pin_slam_torch.ops import rows

    zeros = torch.zeros_like(table)
    errs, ratios = [], []
    for form, base, fn in (
            ("zero-base", zeros,
             lambda: rows.scatter_sum_rows(n_rows, idx, val, plan=plan, skip_row=skip)),
            ("table", table,
             lambda: rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip))):
        out, again = fn(), fn()
        if out.is_cuda:
            torch.cuda.synchronize()
        identical_check(out, again, f"scatter kernel {form} {label}")
        ordered_check(out, rows.scatter_add_rows_ordered(base, idx, val, skip),
                      f"{form} {label}")
        err, ratio = scatter_check(out, base, idx, val, skip)
        errs.append(err)
        ratios.append(ratio)
        if form == "zero-base":
            out_z = out
    return out_z, max(errs), max(ratios)


def scatter_bounds(n_rows, C, idx, skip):
    """(bound_ms, bound_by, table_bound_ms) of a scatter.  The zero-base
    form must read the value rows that are not skipped and their entries of
    the int32 ``order``, the int32 offsets (N + 1), and write the (N, C)
    sums; one add per value element read.  ``table_bound_ms`` is the table
    form as the int64-plan kernel counted it: the table, the int64 indices
    and every value read, the table written, M * C adds."""
    M = idx.shape[0]
    m = M - (int((idx == skip).sum()) if skip is not None else 0)
    b, by = bound(4 * (m * C + m + n_rows + 1 + n_rows * C), m * C)
    tb, _ = bound(4 * (2 * n_rows * C + M * C) + 8 * M, M * C)
    return b, by, tb


def scatter_phase(label, n_rows, idx, val, plan, skip, launches, frame_idx=None):
    """The row scatter on one input: both forms checked (``scatter_forms``:
    the table form onto a seeded random table); timed, the zero-base form
    (the main path's call, plan given), the plain version and
    ``Tensor.index_add`` on a zero table, and the table form's kernel.  The
    plan is timed apart: one iteration's (``plan_ms``) and, where
    ``frame_idx`` holds a training call's (T, M) indices, the call's
    (``frame_plan_ms``, as the mapper builds it once a frame)."""
    import torch

    from pin_slam_torch.ops import rows

    N, C, M = n_rows, val.shape[1], idx.shape[0]
    if plan is None:
        plan = rows.scatter_plans(idx, N)
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(N, C, generator=g, device="cuda")
    zeros = torch.zeros_like(table)
    out_z, err64, ratio = scatter_forms(N, idx, val, plan, skip, table, label)
    out_p = rows.scatter_add_rows_plain(zeros, idx, val, skip)
    t = timings(lambda: rows.scatter_sum_rows(N, idx, val, plan=plan, skip_row=skip),
                lambda: rows.scatter_add_rows_plain(zeros, idx, val, skip),
                lambda: zeros.index_add(0, idx, val))
    tt = timings(lambda: rows.scatter_add_rows(table, idx, val, plan=plan, skip_row=skip), None)
    b, by, tb = scatter_bounds(N, C, idx, skip)
    row = {"name": f"scatter[{label}]", "route": "cuda", "source": "pin_slam_torch/csrc/rows.cu",
           "replaces": "experiments/profile_pallas_gather.py:66", "launches": launches,
           "max_abs_err": float((out_z - out_p).abs().max()), **t,
           "bound_ms": b, "bound_by": by, "table_bound_ms": tb,
           "table_ms": tt["ms"], "table_device_ms": tt["device_ms"],
           "shape": {"N": N, "C": C, "M": M, "skip_row": skip,
                     "skip_row_terms": int((idx == skip).sum()) if skip is not None else 0,
                     "max_segment": int(torch.bincount(idx[idx != skip] if skip is not None
                                                       else idx, minlength=N).max())},
           "plan_ms": time_ms(lambda: rows.scatter_plans(idx, N)),
           "frame_plan_ms": (time_ms(lambda: rows.scatter_plans(frame_idx, N))
                             if frame_idx is not None else None),
           "frame_plan_shape": list(frame_idx.shape) if frame_idx is not None else None,
           "err_vs_f64": err64, "err_over_bound": ratio,
           "check": "zero-base and table forms each bit-identical to scatter_add_rows_ordered "
                    "(a sequential in-order index_add's bits) and across two launches; each "
                    "element within (n+1) * 2^-24 * (|base| + sum|terms|) of the float64 sum"}
    emit({"phase": "kernel", **row})
    return row


def scatter_edge_phase():
    """Both scatter forms at C in {1, 8, 9, 24} (the generic kernel, the
    experiment's and the main path's widths) x N in {1, 33, 4099} x M in
    {0, 1, 5000}, with and without a skipped row: a tenth of the indices on
    one row (a segment of ~500 terms, many rounds), another row fed
    only -0.0 terms (+0.0 in the zero-base form); each bit-identical to
    ``scatter_add_rows_ordered`` and across two launches.  Kept out of the
    kernels line."""
    import torch

    from pin_slam_torch.ops import rows

    g = torch.Generator(device="cuda").manual_seed(12)
    cases = 0
    for C in (1, 8, 9, 24):
        for N in (1, 33, 4099):
            for M in (0, 1, 5000):
                idx = torch.randint(0, N, (M,), generator=g, device="cuda")
                idx[torch.rand(M, generator=g, device="cuda") < 0.1] = N // 2
                val = torch.randn(M, C, generator=g, device="cuda")
                val[idx == N - 1] = -0.0
                table = torch.randn(N, C, generator=g, device="cuda")
                plan = rows.scatter_plans(idx, N)
                for skip in (None, N // 2):
                    scatter_forms(N, idx, val, plan, skip, table,
                                  f"edge C={C} N={N} M={M} skip={skip}")
                    cases += 1
    emit({"phase": "scatter_edges", "cases": cases,
          "check": "zero-base and table forms each bit-identical to scatter_add_rows_ordered "
                   "and across two launches"})


def experiment_shape_rows():
    """The row kernels at the Pallas experiment's own shape (table 65536 x 8,
    98304 random rows), checked and timed like the captured inputs; not a
    main-path shape, so these rows stay out of the kernels line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    L, F, M = 65536, 8, 98304
    tab = torch.randn(L, F, generator=g, device="cuda")
    idx = torch.randint(0, L, (M,), generator=g, device="cuda")
    val = torch.randn(M, F, generator=g, device="cuda")
    gather_phase("experiment", (tab, idx), {}, 0)
    scatter_phase("experiment", L, idx, val, None, None, 0)


def synthetic_train_args(wf, B, k, seed, device="cuda", dyadic=False, vd=3, F=8, H=64):
    """Random inputs at F features, H hidden units (the main path's 8 and 64
    by default) and offset width ``vd``.  ``dyadic``: as for
    ``synthetic_eik_args``, features, IDW weights, offset vectors and
    decoder are small integers over powers of two, so every hidden
    pre-activation is exact in float32."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    nw1 = (F + vd) * H
    if dyadic:
        q = lambda lo, hi, den, *s: torch.randint(lo, hi + 1, s, generator=g,
                                                  device=device).float() / den
        params = torch.cat([q(-32, 32, 128, nw1), q(-8, 8, 64, H), q(-32, 32, 128, H),
                            q(-8, 8, 64, 1)])
        return (q(-16, 16, 8, B, k, F + 1), q(1, 16, 64, B, k),
                q(-8, 8, 32, B, vd if wf else vd * k), r(B) * 0.3, u(B) / B, params, wf,
                0.055, 0.1)
    w = u(B, k)
    w = w / w.sum(1, keepdim=True)
    params = torch.cat([r(nw1) * 0.3, r(H) * 0.1, r(H) * 0.3, r(1) * 0.1])
    return (r(B, k, F + 1), w, r(B, vd if wf else vd * k) * 0.2, r(B) * 0.3,
            u(B) / B, params, wf, 0.055, 0.1)


def synthetic_eik_args(wf, n, k, seed, device="cuda", dyadic=False, vd=3, F=8, H=64):
    """Random eikonal inputs at F features, H hidden units and offset width
    ``vd``.  ``dyadic``: the features, stencil weights, offset vectors and
    decoder are small integers over powers of two, so every hidden
    pre-activation is exact in float32.  The float64 check then sees the
    kernel's own ReLU masks: at a million hidden units a random
    pre-activation within float32 rounding of 0 is likely, and its mask flip
    is a difference of the inputs' conditioning, not of the kernel."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    u = lambda *s: torch.rand(*s, generator=g, device=device)
    nw1 = (F + vd) * H
    if dyadic:
        q = lambda lo, hi, den, *s: torch.randint(lo, hi + 1, s, generator=g,
                                                  device=device).float() / den
        params = torch.cat([q(-32, 32, 128, nw1), q(-8, 8, 64, H), q(-32, 32, 128, H),
                            q(-8, 8, 64, 1)])
        return (q(-16, 16, 8, n, k, F + 1), q(1, 16, 64, 6 * n, k),
                q(-8, 8, 32, 6 * n, vd if wf else vd * k), u(n) * 0.5 / n, params, wf, 0.055,
                0.08)
    wst = u(6 * n, k)
    wst = wst / wst.sum(1, keepdim=True)
    params = torch.cat([r(nw1) * 0.3, r(H) * 0.1, r(H) * 0.3, r(1) * 0.1])
    return (r(n, k, F + 1), wst, r(6 * n, vd if wf else vd * k) * 0.2, u(n) * 0.5 / n,
            params, wf, 0.055, 0.08)


# ----------------------------------------------------------------------
# path I: run_ros_general.yaml through the port's ROS node, under fakes
# ----------------------------------------------------------------------

PATH_I = dict(profile="config/lidar_slam/run_ros_general.yaml", n_frames=16, seed=0,
              n_points=1 << 17, density=2.5, topic="/points")
I_GATE_POS_M = 0.5
I_TOPICS = ("~odometry", "~pin_path", "~map/neural_points", "~frame/mapping",
            "~frame/registration")


def ros_fakes():
    """Stand-ins for ``rospy``, ``tf2_ros``, ``sensor_msgs.point_cloud2`` and
    the message and service modules, enough for ``PinSlamRosNode``: the
    publishers keep their messages, ``read_points`` yields one tuple a point
    as ROS's does, ``create_cloud`` keeps the points.  Returns (modules by
    name, a record of publishers, services and subscribers)."""
    import types

    rec = types.SimpleNamespace(pubs={}, services={}, subscribers={})

    def ns(**kw):
        return types.SimpleNamespace(**kw)

    class Pub:
        def __init__(self, topic):
            self.topic, self.msgs, self.lens = topic, [], []

        def publish(self, m):
            self.msgs.append(m)
            # the path is one message, grown and republished: its length now
            self.lens.append(len(m.poses) if hasattr(m, "poses") else None)

    class Header:
        def __init__(self):
            self.stamp, self.frame_id = None, ""

    class PoseStamped:
        def __init__(self):
            self.header = Header()
            self.pose = ns(orientation=ns(x=0.0, y=0.0, z=0.0, w=1.0),
                           position=ns(x=0.0, y=0.0, z=0.0))

    class Odometry:
        def __init__(self):
            self.header, self.child_frame_id, self.pose = None, "", ns(pose=None)

    class TransformStamped:
        def __init__(self):
            self.header, self.child_frame_id = Header(), ""
            self.transform = ns(rotation=ns(x=0.0, y=0.0, z=0.0, w=1.0),
                                translation=ns(x=0.0, y=0.0, z=0.0))

    class Path:
        def __init__(self):
            self.header, self.poses = Header(), []

    class PointField:
        FLOAT32 = 7

        def __init__(self, name, offset, datatype, count):
            self.name, self.offset = name, offset

    class PointCloud2:
        def __init__(self, pts=None):
            self.pts, self.header = pts, Header()

    class Broadcaster:
        def __init__(self):
            self.sent = []

        def sendTransform(self, m):
            self.sent.append(m)

    def mod(name, **attrs):
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        return m

    rospy = mod("rospy", init_node=lambda name: None,
                get_param=lambda name, default=None: default,
                Publisher=lambda topic, typ, queue_size=10: rec.pubs.setdefault(topic, Pub(topic)),
                Service=lambda name, typ, cb: rec.services.setdefault(name, cb),
                Subscriber=lambda topic, typ, cb, queue_size=4: rec.subscribers.setdefault(topic,
                                                                                           cb),
                Time=ns(now=lambda: time.time()), loginfo=lambda *a, **k: None)
    pc2 = mod("sensor_msgs.point_cloud2",
              read_points=lambda msg, field_names=None, skip_nans=True: map(
                  tuple, msg.pts.tolist()),
              create_cloud=lambda header, fields, pts: ns(header=header, pts=np.asarray(pts)))
    nav_msg = mod("nav_msgs.msg", Path=Path, Odometry=Odometry)
    std_msg = mod("std_msgs.msg", Header=Header)
    geo_msg = mod("geometry_msgs.msg", PoseStamped=PoseStamped,
                  TransformStamped=TransformStamped)
    sens_msg = mod("sensor_msgs.msg", PointCloud2=PointCloud2, PointField=PointField)
    srv_srv = mod("std_srvs.srv", Empty=object, EmptyResponse=ns)
    mods = {"rospy": rospy, "nav_msgs": mod("nav_msgs", msg=nav_msg), "nav_msgs.msg": nav_msg,
            "std_msgs": mod("std_msgs", msg=std_msg), "std_msgs.msg": std_msg,
            "geometry_msgs": mod("geometry_msgs", msg=geo_msg), "geometry_msgs.msg": geo_msg,
            "sensor_msgs": mod("sensor_msgs", msg=sens_msg, point_cloud2=pc2),
            "sensor_msgs.msg": sens_msg, "sensor_msgs.point_cloud2": pc2,
            "std_srvs": mod("std_srvs", srv=srv_srv), "std_srvs.srv": srv_srv,
            "tf2_ros": mod("tf2_ros", TransformBroadcaster=Broadcaster)}
    return mods, rec


def np_cloud_size(count, ladder):
    """The neural-point cloud's size the node publishes for a map of
    ``count`` points: every ``down_rate``-th point, the rate from the
    ladder, one step per 500 k points."""
    down_rate = ladder[min(count // 500000, len(ladder) - 1)]
    return -(-count // down_rate)


def ros_publish_check(pubs, n_tf, counts, ladder):
    """Fails unless the node published, for each of the ``len(counts)``
    frames, one odometry message, one TF (``n_tf`` sent), the path one pose
    longer each frame, a neural-point cloud of ``np_cloud_size(count)``
    points (``counts``: the map's count after each frame), a non-empty
    mapping cloud and, from the second frame on (tracking starts there), a
    non-empty registration cloud."""
    n = len(counts)
    got = {t: len(pubs[t].msgs) if t in pubs else 0 for t in I_TOPICS}
    want = {t: n for t in I_TOPICS}
    want["~frame/registration"] = n - 1
    if got != want or n_tf != n:
        fail(f"path I: messages {got} (TF {n_tf}), expected {want} (TF {n})")
    lengths = pubs["~pin_path"].lens
    if lengths != list(range(1, n + 1)):
        fail(f"path I: path lengths {lengths}")
    sizes = [m.pts.shape[0] for m in pubs["~map/neural_points"].msgs]
    if sizes != [np_cloud_size(c, ladder) for c in counts]:
        fail(f"path I: neural-point clouds of {sizes} points for maps of {counts}")
    for t in ("~frame/mapping", "~frame/registration"):
        if any(m.pts.shape[0] == 0 for m in pubs[t].msgs):
            fail(f"path I: an empty {t} cloud")


def mesh_file_stats(path):
    """(vertex count, all finite) of a PLY mesh; (0, False) when missing."""
    from pin_slam_torch.dataset import io as pio

    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return 0, False
    d = pio.read_ply(path)
    v = np.stack([d["x"], d["y"], d["z"]], 1) if "x" in d else np.zeros((0, 3))
    return int(len(v)), bool(len(v) and np.isfinite(v).all() and len(d.get("faces", [])))


def path_i_scans():
    """``PATH_I["n_frames"] + 1`` sweeps of the labelled corridor's static
    surfaces (path F's scene without its movers), ~98 k points each, in the
    sensor frame, and the scene's poses (the last sweep is the capture
    frame's)."""
    from pin_slam_torch.utils import synthetic as syn

    rng = np.random.default_rng(PATH_I["seed"])
    world = syn.labelled_corridor_world(rng, PATH_I["density"])
    scans, poses = [], []
    for i in range(PATH_I["n_frames"] + 1):
        R, t = syn.labelled_corridor_pose(i)
        scans.append(syn.lidar_scan(rng, world[:2], t, R, PATH_I["n_points"], n_az=1800,
                                    n_el=128).astype(np.float32))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T)
    return scans, np.stack(poses)


def run_path_i(cap):
    """Path I: ``run_ros_general.yaml`` as shipped (a copy changed only in
    ``output_root``) through ``pin_slam_torch.ros.PinSlamRosNode`` under
    ``ros_fakes``: 16 sweeps of the static corridor fed to the node's
    ``frame_callback`` as point-cloud messages (each timed, the message's
    conversion included), one more as the capture frame, then the
    ``save_results`` and ``save_mesh`` services and ``finish``.  Gated (see
    the module docstring) and reported."""
    import shutil

    import torch
    import yaml

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.utils.experiment import load_implicit_map

    t0 = time.perf_counter()
    scans, gt_poses = path_i_scans()
    setup_s = time.perf_counter() - t0
    root = os.path.join(ROOT, "build", "path_i")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open(os.path.join(ROOT, PATH_I["profile"])) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["output_root"] = os.path.join(root, "out")
    yml = os.path.join(root, "run_ros_general.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    from pin_slam_torch.slam.pipeline import SlamSystem

    mods, rec = ros_fakes()
    saved = {name: sys.modules.get(name) for name in mods}
    infos, orig_proc = [], SlamSystem.process_frame

    def proc(self, frame):
        infos.append(orig_proc(self, frame))
        return infos[-1]

    sys.modules.update(mods)
    SlamSystem.process_frame = proc
    try:
        from pin_slam_torch.config import Config
        from pin_slam_torch.ros import PinSlamRosNode

        cfg = Config().load(yml)
        node = PinSlamRosNode(cfg, cloud_topic=PATH_I["topic"])
        system = node.slam.system
        callback = rec.subscribers[PATH_I["topic"]]
        n_frames = PATH_I["n_frames"]
        cap.path = "I"
        cap.plain_rank_calls = 0
        _cuda.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts, poses = [], [], []
        for scan in scans[:n_frames]:
            msg = mods["sensor_msgs.msg"].PointCloud2(scan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            callback(msg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(int(system.state.count))
            poses.append(system.cur_pose.copy())
        launches = dict(_cuda.COUNTS)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        n_tf = len(node.tf_broadcaster.sent)
        ros_publish_check(rec.pubs, n_tf, counts, cfg.publish_np_map_down_rate_list)
        cap.capturing = True
        callback(mods["sensor_msgs.msg"].PointCloud2(scans[n_frames]))
        torch.cuda.synchronize()
        cap.capturing = False
        cap.path = None

        out = node.out_dir
        t0 = time.perf_counter()
        rec.services["~save_results"](None)
        results_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec.services["~save_mesh"](None)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        mesh_v, mesh_ok = mesh_file_stats(os.path.join(out, "mesh", "mesh.ply"))
        t0 = time.perf_counter()
        node.slam.finish(out)
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t0
        state2, _ = load_implicit_map(os.path.join(out, "map", "pin_map.npz"), system.mc)
        reload_ok = (state2.attr_rows.device.type == "cuda"
                     and int(state2.count) == int(system.state.count) > 0
                     and torch.equal(state2.geo_features[:int(state2.count)],
                                     system.state.geo_features[:int(state2.count)]))
        del state2
    finally:
        SlamSystem.process_frame = orig_proc
        cap.capturing = False
        cap.path = None
        for name, m in saved.items():
            if m is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = m

    est = np.stack(poses)
    rel = np.linalg.inv(gt_poses[0]) @ gt_poses[:n_frames]
    err = np.linalg.norm(est[:, :3, 3] - rel[:, :3, 3], axis=1)
    stage = np.asarray(system.stage_times[1:n_frames])
    res = {
        "phase": "path_I", "profile": PATH_I["profile"], "argv": [os.path.relpath(yml, ROOT)],
        "entry": "pin_slam_torch.ros.PinSlamRosNode.frame_callback (fake rospy)",
        "frames": n_frames, "points_per_frame": [min(len(s) for s in scans),
                                                 max(len(s) for s in scans)],
        "setup_s": setup_s, "deskew_in_profile": cfg.deskew, "pgo_on": cfg.pgo_on,
        "weighted_first": cfg.weighted_first, "kernel_path": system.kernel_path,
        "capacities": {"map": cfg.map_capacity, "local": cfg.local_map_capacity,
                       "frame_bucket": cfg.frame_bucket, "source_bucket": cfg.source_bucket,
                       "pool": cfg.pool_capacity, "bs": cfg.bs, "voxel_m": cfg.voxel_size_m,
                       "range_m": [cfg.min_range, cfg.max_range]},
        "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:])),
        "frame0_s": times[0], "callback_ms": [t * 1e3 for t in times],
        "stage_ms_mean_after_frame0": _stage_ms(stage),
        "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:n_frames]],
        "reg_iters": [int(x.get("reg_iters", 0)) for x in infos[1:n_frames]],
        "finite_poses": bool(np.isfinite(est).all()),
        "max_pose_err_m": float(err.max()), "end_pose_err_m": float(err[-1]),
        "map_points": counts, "np_cloud_points": [m.pts.shape[0] for m in
                                                  rec.pubs["~map/neural_points"].msgs],
        "save_results_s": results_s, "save_mesh_s": mesh_s, "finish_s": finish_s,
        "mesh_vertices": mesh_v, "map_reload_ok": reload_ok, "launches": launches,
        "max_memory_allocated_gb": peak_gb, "nvidia_smi": smi_line(),
    }
    emit(res)
    if not res["finite_poses"] or not res["max_pose_err_m"] < I_GATE_POS_M:
        fail(f"path I: pose error {res['max_pose_err_m']:.3f} m vs the corridor's trajectory "
             f"(finite {res['finite_poses']})")
    for f in ("odom_poses_kitti.txt", "odom_poses_tum.txt"):
        if not os.path.exists(os.path.join(out, f)):
            fail(f"path I: the save_results service wrote no {f}")
    if not mesh_ok:
        fail(f"path I: the save_mesh service's mesh: {mesh_v} vertices, finite {mesh_ok}")
    if not reload_ok:
        fail("path I: finish()'s pin_map.npz does not reload on the card")
    iters = cfg.iters * (n_frames + cfg.init_iter_ratio - 1)
    need = {"rank_brick": n_frames, "train_iter": iters, "eikonal": iters,
            "gather": iters + n_frames, "scatter": iters}
    for k, n in need.items():
        if launches[k] < n:
            fail(f"path I: kernel {k} launched {launches[k]} times, expected >= {n}")
    if launches["rank"] or cap.plain_rank_calls:
        fail(f"path I: the per-cell rank ({launches['rank']}) or the plain brick gather "
             f"({cap.plain_rank_calls}) ran")
    del node, system
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# live_C: path C's loop with the in-run artifacts and the control channel
# ----------------------------------------------------------------------

LIVE_FREQ = 32                    # mesh_freq_frame and sdfslice_freq_frame
LIVE_MESH_NOW_AT = 40             # the watcher asks for a mesh once past this frame
LIVE_RETUNE_AT = 48               # and retunes the mesher's resolution past this one
LIVE_RETUNE = 0.625               # the new mc_res_m over the old (5 / 8: the two grids
#                                   share every eighth plane)
LIVE_HOLD_S = 1.0                 # how long the watcher holds the paused run


def grid_share(verts, res, tol=1e-3):
    """The share of mesh vertices with at least one coordinate on the
    marching grid of spacing ``res`` (within ``tol`` x res): marching
    tetrahedra put every vertex on an edge between two grid points, all but
    the cube's main diagonal along a grid line or face, so about 0.8 of the
    vertices of a mesh made at ``res`` have one (a sphere: 0.80-0.81), and
    0.15-0.25 of one made at a spacing 5 / 8 or 8 / 5 of it."""
    v = np.asarray(verts, np.float64) / res
    on = np.abs(v - np.round(v)) < tol
    return float(on.any(1).mean()) if len(v) else 0.0


def _post(port, patch):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/control",
                                 data=json.dumps(patch).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _live_meta(run_dir):
    """The live viewer's status line (viewer_data.js's last object)."""
    import re

    with open(os.path.join(run_dir, "viewer_data.js")) as f:
        m = re.search(r"(\{[^{}]*\})\);\s*$", f.read())
    return json.loads(m.group(1)) if m else {}


def live_c_phase(cap):
    """live_C: path C (the square loop, PGO on) with ``o3d_vis_on``,
    ``mesh_freq_frame`` and ``sdfslice_freq_frame`` 32 and ``pause_at_loop``
    in ``control.json``, the run directory served by
    ``utils/viewer_server.py`` on 127.0.0.1.  A watcher thread POSTs
    ``mesh_now`` once past frame LIVE_MESH_NOW_AT, a retune of ``mc_res_m``
    once past LIVE_RETUNE_AT, and when the loop hook has paused the run it
    holds it LIVE_HOLD_S, then resumes it by POST ``{"pause": false}``.
    Then the map is saved for the vis_pin_map phase.  Gated (see the module
    docstring); returns (report, the saved pin_map.npz)."""
    import shutil
    import threading

    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.utils import viewer_server

    run_dir = os.path.join(ROOT, "build", "live_c")
    shutil.rmtree(run_dir, ignore_errors=True)
    system, frames, gt = make_path("C", over=dict(o3d_vis_on=True, mesh_freq_frame=LIVE_FREQ,
                                                  sdfslice_freq_frame=LIVE_FREQ,
                                                  run_path=run_dir))
    cfg = system.config
    res0 = cfg.mc_res_m
    res1 = float(np.float32(res0 * LIVE_RETUNE))
    system._write_control({"pause_at_loop": True})
    httpd = viewer_server.make_server(run_dir, 0)
    port = httpd.server_address[1]
    serve = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve.start()
    stop = threading.Event()
    seen = {}

    def hold():
        """The first pause: wait until the pipeline holds (its viewer meta
        says paused), hold LIVE_HOLD_S, resume over HTTP."""
        seen["pause_seen_at"] = system.frame_id
        t0 = time.perf_counter()
        while not _live_meta(run_dir).get("paused") and time.perf_counter() - t0 < 120:
            time.sleep(0.02)
        t0 = time.perf_counter()
        time.sleep(LIVE_HOLD_S)
        seen["frame_while_held"] = system.frame_id
        seen["meta_while_held"] = _live_meta(run_dir)
        seen["resume_reply"] = _post(port, {"pause": False})
        seen["held_s"] = time.perf_counter() - t0

    def watch():
        try:
            while not stop.is_set():
                fid = system.frame_id
                ctl = system._read_control()
                if "mesh_now_posted_at" not in seen and fid >= LIVE_MESH_NOW_AT:
                    seen["mesh_now_posted_at"] = fid
                    _post(port, {"mesh_now": True})
                elif ("retune_posted_at" not in seen and fid >= LIVE_RETUNE_AT
                      and "mesh_now" not in ctl):
                    seen["retune_posted_at"] = fid
                    _post(port, {"mc_res_m": res1})
                elif ctl.get("pause"):
                    if "held_s" not in seen:
                        hold()
                    else:                        # a later closure: resume at once
                        seen["later_pauses"] = seen.get("later_pauses", 0) + 1
                        _post(port, {"pause": False})
                time.sleep(0.02)
        except Exception as e:          # recorded, and failed on below
            seen["error"] = repr(e)
        finally:
            # never leave the run held
            system._write_control({**system._read_control(), "pause": False})

    watcher = threading.Thread(target=watch, daemon=True)
    infos, times = [], []
    cap.path = "live_C"
    _cuda.reset_counts()
    watcher.start()
    try:
        for fr in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infos.append(system.process_frame(fr))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        stop.set()
        watcher.join(timeout=30)
        httpd.shutdown()
        httpd.server_close()
        serve.join(timeout=30)
        cap.path = None
    counts = dict(_cuda.COUNTS)
    n = len(frames)
    poses = np.stack(system.dataset.pgo_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    odom = np.stack(system.dataset.odom_poses)
    end_err_odom = float(np.linalg.norm(odom[-1, :3, 3] - gt[len(odom) - 1]))
    loop_edges = [(e.i, e.j) for e in system.pgm.edges if abs(e.j - e.i) > 1]
    closures = [i for i, x in enumerate(infos) if x.get("pgo_applied")]
    mesh_frames = [i for i, x in enumerate(infos) if "mesh" in x.get("vis_ms", {})]
    slice_frames = [i for i, x in enumerate(infos) if "sdf_slice" in x.get("vis_ms", {})]
    cadence = [i for i in range(1, n) if i % LIVE_FREQ == 0]
    now_frames = [i for i in mesh_frames if i not in cadence and i not in closures]
    vis = os.path.join(run_dir, "vis")
    stats = {i: mesh_file_stats(os.path.join(vis, f"mesh_{i:05d}.ply")) for i in mesh_frames}
    retuned = [i for i in cadence if seen.get("retune_posted_at", n) < i]
    shares = {}
    for i in retuned[:1]:
        from pin_slam_torch.dataset import io as pio

        d = pio.read_ply(os.path.join(vis, f"mesh_{i:05d}.ply"))
        v = np.stack([d["x"], d["y"], d["z"]], 1)
        shares = {"frame": i, "new_res": grid_share(v, res1), "old_res": grid_share(v, res0)}
    meta = _live_meta(run_dir) if os.path.exists(os.path.join(run_dir, "viewer_data.js")) else {}
    after_closure = closures[0] + 1 if closures else None
    res = {
        "phase": "live_C", "profile": PATHS["C"]["profile"], "frames": n,
        "frames_per_s": float(n / np.sum(times)), "closure_frames": closures,
        "loop_factors": loop_edges, "after_pgo": system.after_pgo,
        "end_err_pgo_m": float(err[-1]), "end_err_odom_m": end_err_odom,
        "rmse_pgo_m": float(np.sqrt(np.mean(err ** 2))),
        "mesh_frames": mesh_frames, "mesh_now_frames": now_frames, "slice_frames": slice_frames,
        "mesh_vertices": {i: s[0] for i, s in stats.items()},
        "vis_ms": {i: x["vis_ms"] for i, x in enumerate(infos) if x.get("vis_ms")},
        "mc_res_m": [res0, res1], "retune_grid_share": shares, "watcher": seen,
        "frame_after_closure_s": times[after_closure] if after_closure is not None
        and after_closure < n else None,
        "viewer_meta": meta, "warned_keys": sorted(system._warned_keys), "launches": counts,
        "server": f"127.0.0.1:{port}",
    }
    emit(res)
    if not loop_edges or not system.after_pgo or not closures:
        fail(f"live_C: no loop closure (factors {loop_edges}, after_pgo {system.after_pgo})")
    if not (res["end_err_pgo_m"] < 0.3 and res["end_err_pgo_m"] <= end_err_odom + 0.5) \
            or res["rmse_pgo_m"] >= 0.15:
        fail(f"live_C: endpoint error {res['end_err_pgo_m']:.3f} m, RMSE {res['rmse_pgo_m']:.3f}")
    want = sorted(set(cadence) | set(closures))
    if len(now_frames) != 1 or sorted(set(mesh_frames) - set(now_frames)) != want:
        fail(f"live_C: meshes at {mesh_frames}, expected the cadence and closures {want} and "
             f"one mesh_now frame ({now_frames})")
    bad = {i: s for i, s in stats.items() if not s[1]}
    if bad:
        fail(f"live_C: empty or non-finite in-run meshes {bad}")
    if slice_frames != [i for i in range(n) if i % LIVE_FREQ == 0] or not all(
            os.path.getsize(os.path.join(vis, f"sdf_slice_{i:05d}.ply")) > 0
            for i in slice_frames):
        fail(f"live_C: SDF slices at {slice_frames}")
    if not shares or not (shares["new_res"] > 0.6 and shares["old_res"] < 0.4):
        fail(f"live_C: the retuned mesh's vertices on the grids: {shares}")
    if not os.path.exists(os.path.join(run_dir, "viewer.html")) \
            or meta.get("frame") != mesh_frames[-1]:
        fail(f"live_C: live viewer meta {meta}, last mesh frame {mesh_frames[-1]}")
    if ("error" in seen or seen.get("frame_while_held") != after_closure
            or seen.get("resume_reply", {}).get("pause") is not False
            or not seen.get("meta_while_held", {}).get("paused")
            or not res["frame_after_closure_s"] or res["frame_after_closure_s"] < LIVE_HOLD_S):
        fail(f"live_C: the run did not pause after the closure at {closures} and resume: "
             f"{seen}, frame after it {res['frame_after_closure_s']} s")
    if system._warned_keys:
        fail(f"live_C: the pipeline warned: {sorted(system._warned_keys)}")
    for k in counts:
        if k != "rank" and counts[k] < 1:
            fail(f"live_C: kernel {k} never launched")
    cfg.save_map, cfg.save_mesh, cfg.save_merged_pc = True, False, False
    system.save_artifacts(run_dir)
    npz = os.path.join(run_dir, "map", "pin_map.npz")
    del system
    torch.cuda.empty_cache()
    return res, npz


# ----------------------------------------------------------------------
# vis_pin_map: the offline mesher on live_C's saved map
# ----------------------------------------------------------------------

VIS_RES_M = 0.2
VIS_EXTENT = 0.8                  # tests/test_mesh_fullmap.py's extent gate


def xy_extent_ratio(verts, pts):
    """The mesh's xy extent over the map's, the smaller of the two axes."""
    span_pts = np.maximum(_xy_span(np.asarray(pts)), 1e-9)
    return float(np.min(_xy_span(np.asarray(verts)) / span_pts))


def vis_pin_map_phase(npz):
    """``pin_slam_torch.vis_pin_map.main`` in process on ``npz``, on the
    card, at VIS_RES_M.  Gated: a non-empty, finite mesh over at least
    VIS_EXTENT of the map's xy extent, and viewer.html written."""
    import torch

    from pin_slam_torch import vis_pin_map
    from pin_slam_torch.dataset import io as pio
    from pin_slam_torch.ops import _cuda

    out = os.path.join(os.path.dirname(npz), "vis_pin_map", "mesh.ply")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    _cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = vis_pin_map.main([npz, str(VIS_RES_M), out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_v, finite = mesh_file_stats(out)
    with np.load(npz) as blob:
        pts = blob["positions"]
    d = pio.read_ply(out) if n_v else {}
    ratio = xy_extent_ratio(np.stack([d["x"], d["y"], d["z"]], 1), pts) if n_v else 0.0
    viewer = os.path.join(os.path.dirname(out), "viewer.html")
    res = {"phase": "vis_pin_map", "map": os.path.relpath(npz, ROOT), "mc_res_m": VIS_RES_M,
           "rc": rc, "wall_s": wall, "map_points": int(len(pts)), "mesh_vertices": n_v,
           "finite": finite, "xy_extent_ratio": ratio,
           "viewer_html_bytes": os.path.getsize(viewer) if os.path.exists(viewer) else 0,
           "launches": dict(_cuda.COUNTS)}
    emit(res)
    if rc != 0 or not n_v or not finite or not ratio >= VIS_EXTENT or not res["viewer_html_bytes"]:
        fail(f"vis_pin_map: rc {rc}, {n_v} vertices (finite {finite}), xy extent {ratio:.3f} of "
             f"the map's, viewer.html {res['viewer_html_bytes']} bytes")
    return res


# ----------------------------------------------------------------------
# Egen: path E's room with the colour head beside a deeper SDF decoder
# ----------------------------------------------------------------------

EGEN_FRAMES = 8


def egen_phase(cap):
    """Egen: path E's profile (a copy changed in its paths and in
    ``geo_mlp_level: 2``) through ``pin_slam_torch.cli.main`` in process on
    the first 8 frames of path E's room (written under build/ by path E): the
    colour head beside an SDF decoder the training kernels do not take,
    both trained by the autograd loop.  Gated (see the module docstring);
    the last frame's row-kernel inputs are kept for the kernel rows."""
    import torch
    import yaml

    from pin_slam_torch import cli
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.models.decoder import blended_head, regress_color
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    seq = os.path.join(ROOT, "build", "path_e", PATH_E["seq"])
    if not os.path.isdir(os.path.join(seq, "rgbd_ply")):
        fail(f"Egen: path E's room is not under {seq}")
    with open(os.path.join(ROOT, PATH_E["profile"])) as f:
        prof = yaml.safe_load(f)
    prof["setting"]["pc_path"] = os.path.join(seq, "rgbd_ply")
    prof["setting"]["pose_path"] = os.path.join(seq, "poses.txt")
    prof["setting"]["output_root"] = os.path.join(ROOT, "build", "egen", "out")
    prof.setdefault(_section_of("geo_mlp_level"), {})["geo_mlp_level"] = 2
    os.makedirs(os.path.join(ROOT, "build", "egen"), exist_ok=True)
    yml = os.path.join(ROOT, "build", "egen", "run_replica_deep.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump(prof, f)

    got, infos, calls, rerun = {}, [], [], {}
    orig_proc, orig_loop = SlamSystem.process_frame, mp.mapping_loop_autograd

    def proc(self, frame):
        got["system"] = self
        cap.store = self.frame_id == EGEN_FRAMES - 1
        try:
            infos.append(orig_proc(self, frame))
            return infos[-1]
        finally:
            cap.store = False

    def loop(*a, **kw):
        system = got["system"]
        snap = "snap" not in rerun and system.frame_id == E_RERUN_FRAME
        if snap:
            rerun["snap"] = ([_clone(x) for x in a], {k: _clone(v) for k, v in kw.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_loop(*a, **kw)
        torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "iters": int(out[4].shape[0]),
                      "finite": bool(torch.isfinite(out[4]).all())})
        if snap:
            color = kw["color"]
            rerun["out"] = ([out[1].clone()] + [p.clone() for p in out[2].leaves()]
                            + [color.features.clone()] + [p.clone() for p in color.params])
        return out

    cap.path = "Egen"
    cap.plain_rank_calls = 0
    _cuda.reset_counts()
    SlamSystem.process_frame, mp.mapping_loop_autograd = proc, loop
    try:
        t0 = time.perf_counter()
        rc = cli.main([yml, "--frames", str(EGEN_FRAMES)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        SlamSystem.process_frame, mp.mapping_loop_autograd = orig_proc, orig_loop
        cap.path = None
    counts = dict(_cuda.COUNTS)
    system = got.get("system")
    if rc != 0 or system is None:
        fail(f"Egen: the CLI returned {rc}")
    repeat_ok = None
    if "snap" in rerun:
        a, kw = rerun["snap"]
        out = orig_loop(*a, **kw)
        color = kw["color"]
        again = ([out[1]] + list(out[2].leaves()) + [color.features] + list(color.params))
        repeat_ok = all(_bits_equal(x, y) for x, y in zip(again, rerun["out"]))
        del a, kw, out, again, rerun["snap"]
    ds, mc = system.dataset, system.mc
    est = np.stack(ds.odom_poses)
    err = np.linalg.norm(est[:, :3, 3] - ds.gt_poses[:len(est), :3, 3], axis=1)
    count = int(system.state.count)
    pts = system.state.positions[:count]
    errs, n_full = [], 0
    with torch.no_grad():
        for s in range(0, count, 1 << 16):
            p = pts[s:s + (1 << 16)]
            knn = npts.knn_search(system.lm, mc, p, system.offsets)
            _, col, w, _ = npts.interpolate_features(system.lm, mc, p, knn.lidx,
                                                     query_color=True)
            pred = blended_head(regress_color, system.color_decoder, col, w, mc.weighted_first)
            full = knn.nn_count >= 6
            target = torch.as_tensor(syn.world_color(p.cpu().numpy()), device=p.device)
            errs.append(torch.abs(pred - target)[full].sum(0).cpu().numpy())
            n_full += int(full.sum())
    color_mae = float(np.sum(errs) / max(3 * n_full, 1))
    iters = sum(c["iters"] for c in calls)
    tally = {f"{k}-{x}": cap.tally.get(("Egen", k, x), 0)
             for k, xs in (("gather", ("pool", "label", "feat", "color")),
                           ("scatter", ("main", "color"))) for x in xs}
    res = {"phase": "Egen", "profile": PATH_E["profile"], "argv": [os.path.relpath(yml, ROOT),
                                                                  "--frames", str(EGEN_FRAMES)],
           "geo_mlp_level": system.config.geo_mlp_level, "kernel_path": system.kernel_path,
           "color_on": system.config.color_on, "rc": rc, "run_s": run_s, "frames": len(infos),
           "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
           "max_pose_err_m": float(err.max()), "map_points_full_nbhd": n_full,
           "color_mae": color_mae, "train_calls": len(calls), "train_iters": iters,
           "train_ms_per_iter": float(sum(c["ms"] for c in calls) / max(iters, 1)),
           "train_rerun_bit_identical": repeat_ok, "row_tallies": tally, "launches": counts}
    emit(res)
    if system.kernel_path or system.color_decoder is None or not calls:
        fail("Egen: the colour head did not train in the autograd loop")
    if len(infos) != EGEN_FRAMES or not all(res["reg_valid"]) \
            or not res["max_pose_err_m"] < E_GATE_POS_M:
        fail(f"Egen: registration {res['reg_valid']}, pose error {res['max_pose_err_m']:.3f} m")
    if not color_mae < E_GATE_COLOR or n_full == 0:
        fail(f"Egen: colours regressed at {n_full} map points {color_mae:.3f} from the field")
    if counts["train_iter"] or counts["eikonal"]:
        fail(f"Egen: training kernels launched ({counts['train_iter']}, {counts['eikonal']})")
    if not all(c["finite"] for c in calls):
        fail("Egen: a non-finite training loss")
    if any(tally[k] != iters for k in ("gather-feat", "gather-color", "scatter-main",
                                       "scatter-color")) \
            or tally["gather-label"] != len(calls):
        fail(f"Egen: row-kernel launches {tally} for {iters} iterations in {len(calls)} calls")
    if not repeat_ok:
        fail(f"Egen: frame {E_RERUN_FRAME}'s training call rerun from its inputs differs")
    del system, got
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# multi-device: data parallelism and map sharding over torch.distributed
# ----------------------------------------------------------------------

DP_WORLD = 2                      # dp_B's and shard_C's ranks, both on cuda:0 under gloo
DP_FRAMES = 8                     # dp_B's timed frames (path B's)
DP_RERUN_FRAME = 5                # dp_B's training call rerun from its snapshot
CHILD_TIMEOUT_S = 420             # each two-process phase, children killed past it
# the one-rank loop on the two ranks' stitched indices against the DP loop:
# tests/test_torch_parallel.py's tolerances (those of tests/test_parallel.py)
DP_TOL_HIST = dict(rtol=1e-4, atol=1e-6)
DP_TOL_FEATS = dict(rtol=1e-3, atol=2e-5)
SHARD_COUNT_TOL = 0.02            # tests/test_spatial.py's live-backend count tolerance


class CollectiveTimer:
    """Wraps the collectives ``parallel.mesh`` calls: each is timed on the
    host between two device synchronisations (the instrumentation adds the
    syncs; gloo's collectives on CUDA tensors stage through the host and
    block anyway), counted, and its bytes summed."""

    def __init__(self):
        import torch.distributed as dist

        from pin_slam_torch.parallel import mesh as pmesh

        self.pmesh, self.dist = pmesh, dist
        self.reset()

    def reset(self):
        self.calls, self.ms, self.bytes = {}, {}, {}

    def _wrap(self, name):
        import torch

        real = getattr(self.dist, name)

        def timed(*a, **kw):
            t = a[0] if name != "all_gather" else a[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            self.calls[name] = self.calls.get(name, 0) + 1
            self.bytes[name] = self.bytes.get(name, 0) + t.numel() * t.element_size()
            return out

        return timed

    def install(self):
        import types

        ns = types.SimpleNamespace(**{k: getattr(self.dist, k) for k in dir(self.dist)
                                      if not k.startswith("__")})
        for name in ("all_reduce", "all_gather"):
            setattr(ns, name, self._wrap(name))
        self.pmesh.dist = ns

    def uninstall(self):
        self.pmesh.dist = self.dist

    def summary(self, iters, frames):
        out = {"calls": dict(self.calls), "bytes": dict(self.bytes),
               "ms": {k: float(v) for k, v in self.ms.items()}}
        total = sum(self.ms.values())
        out["ms_per_frame"] = total / max(frames, 1)
        if iters:
            out["all_reduce_ms_per_iter"] = self.ms.get("all_reduce", 0.0) / iters
        return out


def _digest(*ts):
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in ts:
        a = t.detach().cpu().contiguous().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _rel_close(a, b, rtol, atol):
    """Whether ``a`` is within ``atol + rtol |b|`` of ``b`` everywhere, and the
    largest excess ratio."""
    import torch

    a, b = a.double(), b.double()
    ratio = float(torch.max(torch.abs(a - b) / (atol + rtol * torch.abs(b))))
    return ratio <= 1.0, ratio


def dp_nccl1_phase():
    """World size 1 over NCCL on cuda:0, brought up by ``initialize()`` from
    torchrun's variables set in this process: the DP mapping loop at path
    B's widths (run_kitti.yaml, KITTI capacities, bs 16384 x 15), whose
    collectives run, bit-identical to ``mapping_loop_cached`` on the same
    indices; the DP mesher's grid query over one chunk identical to the
    plain query."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.parallel import distributed as pdist
    from pin_slam_torch.parallel import launch
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.slam import mapper as mp
    from pin_slam_torch.slam.mesher import Mesher, MesherConfig

    env = dict(PIN_SLAM_DIST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch.free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not pdist.initialize():
            fail("dp_nccl1: initialize() did not start the process group")
        inf = pdist.info()
        if inf.backend != "nccl" or inf.device != torch.device("cuda", 0):
            fail(f"dp_nccl1: {inf.backend} on {inf.device}, expected nccl on cuda:0")
        mesh = pdist.make_global_mesh(1)
        system, frames, _ = make_path("B", 3)
        for fr in frames[:2]:
            system.process_frame(fr)
        cfg, mc, mcfg = system.config, system.mc, system.mcfg
        lm = system.lm
        feats, gvec = system._with_cert_column(lm), system.decoder.pack()
        gen = torch.Generator(device="cuda").manual_seed(11)
        idx = mp.sample_batch_indices(gen, system.pool, mcfg,
                                      torch.tensor(True, device="cuda"), int(cfg.iters))

        def call(loop, **kw):
            f, g = feats.clone(), gvec.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = loop(_clone(lm), mc, f, g, mp.init_opt_state(f, g), system.pool, mcfg, idx,
                       1.0, system.after_pgo, **kw)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        ref, ref_ms = call(mp.mapping_loop_cached)
        _cuda.reset_counts()
        timer = CollectiveTimer()
        timer.install()
        try:
            dp, dp_ms = call(mp.mapping_loop_cached, mesh=mesh)
        finally:
            timer.uninstall()
        counts = dict(_cuda.COUNTS)
        same = {name: _bits_equal(a, b) for name, a, b in (
            ("hist", ref[4], dp[4]), ("feats", ref[1], dp[1]), ("decoder", ref[2], dp[2]),
            ("attr", ref[0].attr_rows, dp[0].attr_rows))}

        mcf = MesherConfig(mc_res_m=cfg.mc_res_m, mesh_min_nn=cfg.mesh_min_nn,
                           query_bucket=cfg.mesh_query_bucket)
        count = int(lm.count)
        pos = lm.positions[:count]
        g = torch.Generator(device="cuda").manual_seed(12)
        coords = (pos[torch.randint(0, count, (cfg.mesh_query_bucket,), device="cuda",
                                    generator=g)]
                  + 0.1 * torch.randn((cfg.mesh_query_bucket, 3), device="cuda",
                                      generator=g)).cpu().numpy()
        sdf1, nn1 = Mesher(mcf, mc, system.offsets).query_sdf_grid(lm, system.decoder,
                                                                  system.sdf_scale, coords)
        sdf2, nn2 = Mesher(mcf, mc, system.offsets, dp_mesh=mesh).query_sdf_grid(
            lm, system.decoder, system.sdf_scale, coords)
        res = {"phase": "dp_nccl1", "backend": inf.backend, "device": str(inf.device),
               "world": inf.world, "bs": mcfg.bs, "iters": int(cfg.iters),
               "weighted_first": cfg.weighted_first, "bit_identical": same,
               "plain_loop_ms": ref_ms, "dp_loop_ms": dp_ms, "launches": counts,
               "collectives": timer.summary(int(cfg.iters), 1),
               "mesher_chunk": {"points": int(coords.shape[0]),
                                "sdf_identical": bool(np.array_equal(sdf1, sdf2)),
                                "nn_identical": bool(np.array_equal(nn1, nn2))}}
        emit(res)
        if not all(same.values()):
            fail(f"dp_nccl1: the DP loop over NCCL differs from the plain loop: {same}")
        if not (res["mesher_chunk"]["sdf_identical"] and res["mesher_chunk"]["nn_identical"]):
            fail("dp_nccl1: the DP mesher's grid query differs from the plain query")
        for k in ("train_iter", "eikonal", "gather", "scatter"):
            if counts[k] < int(cfg.iters):
                fail(f"dp_nccl1: kernel {k} launched {counts[k]} times in the DP loop")
        del system
        torch.cuda.empty_cache()
        return res
    finally:
        pdist.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _spawn_phase(name, child):
    """Run ``chip_smoke:<child>`` as DP_WORLD processes on cuda:0 under gloo
    (the kernels built by this process, which the children only load);
    returns rank 0's result file.  A child's failure fails the run."""
    from pin_slam_torch.parallel import launch

    work = os.path.join(ROOT, "build", name)
    os.makedirs(work, exist_ok=True)
    for f in os.listdir(work):
        if f.endswith(".json"):
            os.remove(os.path.join(work, f))
    t0 = time.perf_counter()
    try:
        launch.spawn(DP_WORLD, f"chip_smoke:{child}", work, workdir=work,
                     env={"PIN_SLAM_DIST_BACKEND": "gloo"}, timeout=CHILD_TIMEOUT_S,
                     pythonpath=[ROOT])
    except RuntimeError as e:
        fail(f"{name}: {e}")
    wall = time.perf_counter() - t0
    outs = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs, wall


def _child_start(name):
    import torch

    from pin_slam_torch.parallel import distributed as pdist

    if not pdist.initialize():
        raise SystemExit(f"{name}: no process group configured")
    inf = pdist.info()
    if inf.backend != "gloo" or inf.device != torch.device("cuda", 0):
        raise SystemExit(f"{name}: {inf.backend} on {inf.device}, expected gloo on cuda:0")
    return inf


def _child_write(work, rank, res):
    with open(os.path.join(work, f"rank{rank}.json.tmp"), "w") as f:
        json.dump(res, f)
    os.replace(os.path.join(work, f"rank{rank}.json.tmp"), os.path.join(work, f"rank{rank}.json"))


def dp_b_child(work):
    """One rank of dp_B: path B's profile and scene with ``dp_devices: 2``,
    DP_FRAMES timed frames and a capture frame, the snapshot rerun, the
    end-of-run mesh through the DP mesher; rank 0 checks and times the
    kernels at its per-rank shapes."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.parallel import mesh as pmesh
    from pin_slam_torch.slam import mapper as mp

    inf = _child_start("dp_B")
    cap = Capture()
    cap.install()
    timer = CollectiveTimer()
    system, frames, gt = make_path("B", DP_FRAMES + 1, over={"dp_devices": DP_WORLD})
    frames, capture_frame = frames[:-1], frames[-1]
    cfg, mc = system.config, system.mc
    snap = {}
    loop = system._dp_loop

    def spy(lm, mc_, feats, params, opt, pool, idx, scale, after_pgo=False, color=None):
        if system.frame_id == DP_RERUN_FRAME and not snap:
            snap.update(lm=_clone(lm), feats=feats.clone(), params=params.clone(),
                        pool=_clone(pool), idx=idx.clone(), scale=scale, after_pgo=after_pgo)
        return loop(lm, mc_, feats, params, opt, pool, idx, scale, after_pgo, color=color)

    system._dp_loop = spy
    cap.path = "dp_B"
    _cuda.reset_counts()
    timer.install()
    infos, times = [], []
    try:
        for fr in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infos.append(system.process_frame(fr))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        timer.uninstall()
    counts = dict(_cuda.COUNTS)
    n_frames = len(frames)
    iters = int(cfg.iters) * (n_frames + cfg.init_iter_ratio - 1)
    poses = np.stack(system.dataset.odom_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    res = {"rank": inf.rank, "frames": n_frames, "bs_per_rank": system.train_mcfg.bs,
           "frames_per_s_after_frame0": float(1.0 / np.mean(times[1:])),
           "frame0_s": times[0], "stage_ms_mean_after_frame0": _stage_ms(
               np.asarray(system.stage_times[1:n_frames])),
           "reg_valid": [bool(x.get("reg_valid")) for x in infos[1:]],
           "max_pose_err_m": float(err.max()),
           "loss_finite": all(x.get("loss_finite", False) for x in infos),
           "map_points": int(system.state.count), "launches": counts,
           "collectives": timer.summary(iters, n_frames),
           "digest": {"poses": _digest(poses),
                      "map": _digest(system.state.attr_rows, system.state.geo_features),
                      "decoder": _digest(system.decoder.pack())}}
    cap.capturing = True
    system.process_frame(capture_frame)
    torch.cuda.synchronize()
    cap.capturing, cap.path = False, None
    res["iters_total"] = iters

    # the snapshot's training call: the DP loop (twice, bit-identical) against
    # the one-rank loop on the stitched indices, eikonal off (the two take
    # different eikonal rows by construction)
    no_eik = dataclasses.replace(system.mcfg, ekional_loss_on=False)
    dp_loop = pmesh.make_sharded_mapping_loop(system.dp_mesh, no_eik)

    def run(fn, idx, mcfg=None, **kw):
        f, g = snap["feats"].clone(), snap["params"].clone()
        args = (_clone(snap["lm"]), mc, f, g, mp.init_opt_state(f, g), snap["pool"])
        if mcfg is None:
            return fn(*args, idx, snap["scale"], snap["after_pgo"])
        return fn(*args, mcfg, idx, snap["scale"], snap["after_pgo"], **kw)

    d1 = run(dp_loop, snap["idx"])
    d2 = run(dp_loop, snap["idx"])
    stitched = torch.cat(list(pmesh.all_gather(system.dp_mesh, snap["idx"])), dim=1)
    one = run(mp.mapping_loop_cached, stitched, no_eik)
    F = mc.feature_dim
    ok_h, r_h = _rel_close(d1[4], one[4], **DP_TOL_HIST)
    ok_f, r_f = _rel_close(d1[1][:, :F], one[1][:, :F], **DP_TOL_FEATS)
    res["rerun"] = {"frame": DP_RERUN_FRAME, "stitched_bs": int(stitched.shape[1]),
                    "dp_twice_identical": _bits_equal(d1[1], d2[1]) and _bits_equal(d1[4], d2[4]),
                    "hist_ok": ok_h, "hist_excess": r_h, "feats_ok": ok_f, "feats_excess": r_f,
                    "tolerances": {"hist": DP_TOL_HIST, "feats": DP_TOL_FEATS}}

    # the end of the run: the whole map's mesh through the DP mesher
    cfg.save_mesh, cfg.save_map, cfg.save_merged_pc = True, False, False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verts, faces, _ = system.save_artifacts(os.path.join(work, f"run{inf.rank}"))
    res["mesh"] = {"vertices": int(len(verts)), "faces": int(len(faces)),
                   "finite": bool(np.isfinite(verts).all()) if len(verts) else False,
                   "s": time.perf_counter() - t0}

    rows = []
    if inf.rank == 0:
        for kind in ("train_iter", "eikonal"):
            a, kw = cap.inputs[("dp_B", kind, "main")]
            phase = train_phase if kind == "train_iter" else eik_phase
            rows.append(phase("dp_B", a, kw, counts[kind]))
        for kind in ("pool", "feat"):
            a, kw = cap.inputs[("dp_B", "gather", kind)]
            rows.append(gather_phase(f"dp_B-{kind}", a, kw, cap.tally[("dp_B", "gather", kind)]))
        (frame_idx, _), _ = cap.inputs[("dp_B", "plans", "frame")]
        (n_rows, idx, val), kw = cap.inputs[("dp_B", "scatter", "main")]
        rows.append(scatter_phase("dp_B", n_rows, idx, val, kw.get("plan"), kw.get("skip_row"),
                                  cap.tally[("dp_B", "scatter", "main")], frame_idx))
    cap.uninstall()
    res["rows"] = rows
    _child_write(work, inf.rank, res)


def dp_b_phase():
    """dp_B: path B with ``dp_devices: 2`` as two processes on cuda:0 under
    gloo.  Gates: B's own gates; both ranks' poses, map and decoder
    bit-identical; the snapshot's DP loop rerun bit-identically and held to
    the one-rank loop on the stitched indices; every kernel launched; the
    DP mesher's end-of-run mesh non-empty and finite; rank 0's kernel rows
    at the per-rank shapes (B = bs / 2) held to their plain twins."""
    outs, wall = _spawn_phase("dp_B", "dp_b_child")
    r0 = outs[0]
    res = {"phase": "dp_B", "ranks": DP_WORLD, "backend": "gloo", "device": "cuda:0",
           "wall_s": wall, **{k: v for k, v in r0.items() if k != "rows"}}
    emit(res)
    for row in r0["rows"]:
        emit({"phase": "kernel", **row})
    if any(o["digest"] != r0["digest"] for o in outs):
        fail(f"dp_B: the ranks' poses, map or decoder differ: {[o['digest'] for o in outs]}")
    if not all(r0["reg_valid"]) or r0["max_pose_err_m"] > 0.5 or not r0["loss_finite"]:
        fail(f"dp_B: path B's gates: reg_valid {r0['reg_valid']}, pose error "
             f"{r0['max_pose_err_m']:.3f} m, loss finite {r0['loss_finite']}")
    n, it = r0["frames"], r0["iters_total"]
    need = {"rank_brick": n, "train_iter": it, "eikonal": it, "gather": it + n, "scatter": it}
    for k, v in need.items():
        if r0["launches"][k] < v:
            fail(f"dp_B: kernel {k} launched {r0['launches'][k]} times, expected >= {v}")
    rr = r0["rerun"]
    if not (rr["dp_twice_identical"] and rr["hist_ok"] and rr["feats_ok"]):
        fail(f"dp_B: the rerun training call: {rr}")
    if not (r0["mesh"]["vertices"] and r0["mesh"]["finite"]):
        fail(f"dp_B: the DP mesher's mesh: {r0['mesh']}")
    return res, r0["rows"]


def shard_c_child(work):
    """One rank of shard_C: path C (PGO on, the square loop) with
    ``map_shards: 2``, a capture frame, then the end of the run (densify,
    save_map, save_mesh); rank 0 checks and times the rank kernel on its
    inputs."""
    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.utils.experiment import load_implicit_map

    inf = _child_start("shard_C")
    cap = Capture()
    cap.install()
    timer = CollectiveTimer()
    system, frames, gt = make_path("C", over={"map_shards": DP_WORLD})
    cfg = system.config
    cap.path = "shard_C"
    _cuda.reset_counts()
    timer.install()
    infos, times = [], []
    try:
        for fr in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infos.append(system.process_frame(fr))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        timer.uninstall()
    counts = dict(_cuda.COUNTS)
    ds = system.dataset
    poses = np.stack(ds.pgo_poses)
    err = np.linalg.norm(poses[:, :3, 3] - np.stack(gt[:len(poses)]), axis=1)
    odom = np.stack(ds.odom_poses)
    cap.capturing = True
    system.process_frame(frames[-1])
    torch.cuda.synchronize()
    cap.capturing, cap.path = False, None
    res = {"rank": inf.rank, "frames": len(frames),
           "frames_per_s": float(len(frames) / np.sum(times)),
           "closure_frames": [i for i, x in enumerate(infos) if x.get("pgo_applied")],
           "loop_factors": [(e.i, e.j) for e in system.pgm.edges if abs(e.j - e.i) > 1],
           "after_pgo": system.after_pgo, "end_err_pgo_m": float(err[-1]),
           "end_err_odom_m": float(np.linalg.norm(odom[-1, :3, 3] - gt[len(odom) - 1])),
           "rmse_pgo_m": float(np.sqrt(np.mean(err ** 2))),
           "map_points": system._map_count(), "shard_points": int(system.state.count),
           "launches": counts, "collectives": timer.summary(0, len(frames)),
           "digest": {"poses": _digest(poses)}}
    cfg.save_map, cfg.save_mesh, cfg.save_merged_pc = True, True, False
    run_dir = os.path.join(work, f"run{inf.rank}")
    t0 = time.perf_counter()
    verts, faces, _ = system.save_artifacts(run_dir)
    count = int(system.state.count)
    pts = system.state.positions[:count].cpu().numpy()
    res["end"] = {"s": time.perf_counter() - t0, "finalized_points": count,
                  "vertices": int(len(verts)), "faces": int(len(faces)),
                  "finite": bool(np.isfinite(verts).all()) if len(verts) else False,
                  "xy_extent_ratio": xy_extent_ratio(verts, pts) if len(verts) else 0.0}
    rows = []
    if inf.rank == 0:
        npz = os.path.join(run_dir, "map", "pin_map.npz")
        state2, _ = load_implicit_map(npz, system.mc)
        res["end"]["reloaded_points"] = int(state2.count)
        res["end"]["reload_equal"] = bool(int(state2.count) == count and torch.equal(
            state2.attr_rows[:count, :3], system.state.attr_rows[:count, :3]))
        for kind in ("far", "near"):
            key = ("shard_C", "rank_brick", kind)
            rows.append(rank_brick_phase(f"shard_C-{kind}", cap.inputs[key][0], cap.tally[key]))
    cap.uninstall()
    res["rows"] = rows
    _child_write(work, inf.rank, res)


def shard_c_phase(c1):
    """shard_C: path C with ``map_shards: 2`` as two processes on cuda:0
    under gloo.  Gates: C's closure and error gates; the shards' summed
    count within tests/test_spatial.py's tolerance of path C's (map_shards
    1) count ``c1``; both ranks' poses identical; the densified map saved,
    reloaded equal, and meshed over >= 0.8 of its xy extent."""
    outs, wall = _spawn_phase("shard_C", "shard_c_child")
    r0 = outs[0]
    res = {"phase": "shard_C", "ranks": DP_WORLD, "backend": "gloo", "device": "cuda:0",
           "wall_s": wall, "map_points_map_shards_1": c1,
           **{k: v for k, v in r0.items() if k != "rows"}}
    emit(res)
    for row in r0["rows"]:
        emit({"phase": "kernel", **row})
    if any(o["digest"] != r0["digest"] for o in outs):
        fail("shard_C: the ranks' poses differ")
    if not r0["loop_factors"] or not r0["after_pgo"]:
        fail(f"shard_C: no loop closure ({r0['loop_factors']}, after_pgo {r0['after_pgo']})")
    if not (r0["end_err_pgo_m"] < 0.3 and r0["end_err_pgo_m"] <= r0["end_err_odom_m"] + 0.5):
        fail(f"shard_C: endpoint error {r0['end_err_pgo_m']:.3f} m")
    if r0["rmse_pgo_m"] >= 0.15:
        fail(f"shard_C: position RMSE {r0['rmse_pgo_m']:.3f} m")
    c2 = r0["map_points"]
    if abs(c1 - c2) > max(3, SHARD_COUNT_TOL * c1):
        fail(f"shard_C: {c2} points over the shards against {c1} with map_shards 1")
    end = r0["end"]
    if not (end["reload_equal"] and end["vertices"] and end["finite"]
            and end["xy_extent_ratio"] >= VIS_EXTENT):
        fail(f"shard_C: the end of the run: {end}")
    for k in ("rank_brick", "train_iter", "eikonal", "gather", "scatter", "pool_pass"):
        if r0["launches"][k] < 1:
            fail(f"shard_C: kernel {k} never launched")
    return res, r0["rows"]


# ----------------------------------------------------------------------
# the tracker's cached Gauss-Newton step (ops/track_kernel.py)
# ----------------------------------------------------------------------

# N, g and the residual against the twin, as a share of each one's own
# scale (the sum of its terms' magnitudes, ``track_scales``): the kernel
# sums rows, warps and blocks in its own fixed order, the twin through
# cuBLAS and torch's reductions
TRACK_TOL = 1e-5
TRACK_EDGE_WIDTHS = ((8, 64), (3, 20), (16, 128), (64, 256))


class TrackTwin:
    """Wraps ``tracker.track_frame`` while the paths run.  Every call that
    launched the track-step kernel is run again with the kernel's plain twin
    (``track_kernel.track_step_plain``, the same inputs) and the two results'
    iterations, validity and convergence are compared; each iteration's step
    is recorded as its stop ratio, max(rotation / term_thre_deg, translation
    / term_thre_m) (the step converges below 1), read where the tracker
    calls ``so3_expmap`` on the step.  The first kernel step's inputs of a
    path's capture frame (``cap.capturing`` or ``cap.store``) are kept for
    the kernel rows.  ``replay_s`` sums the replays' seconds (``run_path``
    takes them out of its frame times)."""

    def __init__(self, cap):
        from pin_slam_torch.ops import track_kernel
        from pin_slam_torch.slam import tracker

        self.cap, self.tk, self.trk = cap, track_kernel, tracker
        self.orig = (tracker.track_frame, track_kernel.track_step, tracker.so3_expmap)
        self.inputs = {}
        self.frames = {}                  # path -> [(kernel, twin) decisions]
        self.flips = []
        self.replay_s = 0.0
        self.steps = []

    def install(self):
        import copy
        import math
        import types

        import torch

        from pin_slam_torch.ops import _cuda

        track_frame, track_step, so3_expmap = self.orig
        cap = self

        def step(*a, **kw):
            path = cap.cap.path
            if (cap.cap.capturing or cap.cap.store) and path not in cap.inputs:
                lm = a[1]
                keep = [x.clone() if isinstance(x, torch.Tensor) else x for x in a[4:]]
                extra = dict(zip(("after_pgo", "source_normals", "source_normal_valid"),
                                 keep[7:]), **kw)
                cap.inputs[path] = (
                    [a[0]._make(x.clone() for x in a[0]),
                     types.SimpleNamespace(geo_features=lm.geo_features.clone(),
                                           attr_rows=lm.attr_rows.clone(),
                                           origin=lm.origin.clone()),
                     a[2], copy.deepcopy(a[3])] + keep[:7], extra)
            return track_step(*a, **kw)

        def expmap(w):
            # w = xi[:3] of the tracker's scaled step xi; its translation is xi[3:]
            dR = so3_expmap(w)
            rot = math.degrees(math.acos(max(-1.0, min(1.0, (float(torch.trace(dR)) - 1) / 2))))
            xi = w._base if w._base is not None else w
            cap.steps.append((rot, float(torch.linalg.norm(xi[3:]))))
            return dR

        def frame(*a, **kw):
            before = _cuda.COUNTS["track_step"]
            cap.steps = []
            res = track_frame(*a, **kw)
            if _cuda.COUNTS["track_step"] == before:
                return res
            tc = a[2]
            ratios = [[max(r / tc.term_thre_deg, d / tc.term_thre_m) for r, d in cap.steps]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cap.tk.track_step = lambda *s, **skw: cap.tk.track_step_plain(*s[:9], *s[10:], **skw)
            cap.steps = []
            try:
                twin = track_frame(*a, **kw)
            finally:
                cap.tk.track_step = step
            ratios.append([max(r / tc.term_thre_deg, d / tc.term_thre_m) for r, d in cap.steps])
            torch.cuda.synchronize()
            cap.replay_s += time.perf_counter() - t0
            got = [(r.iterations, r.valid, r.converged) for r in (res, twin)]
            path = cap.cap.path
            cap.frames.setdefault(path, []).append(got)
            if got[0] != got[1]:
                n = min(got[0][0], got[1][0])
                dt = float(torch.linalg.norm(res.t - twin.t))
                rot = math.degrees(math.acos(max(-1.0, min(1.0, (float(torch.trace(
                    res.R @ twin.R.T)) - 1) / 2))))
                cap.flips.append({
                    "path": path, "call": len(cap.frames[path]) - 1,
                    "kernel_iters_valid_converged": got[0], "twin_iters_valid_converged": got[1],
                    "stop_ratio_at_deciding_step": [rs[n - 1] if 0 < n <= len(rs) else None
                                                    for rs in ratios],
                    "poses_apart_over_stop": [dt / tc.term_thre_m, rot / tc.term_thre_deg],
                    "same_registration": (got[0][1:] == got[1][1:] == (True, True)
                                          and abs(got[0][0] - got[1][0]) == 1
                                          and dt < tc.term_thre_m and rot < tc.term_thre_deg),
                    "residual_cm": [res.sdf_residual_cm, twin.sdf_residual_cm],
                    "valid_count": [res.valid_count, twin.valid_count],
                    "min_eigenvalue": [res.min_eigenvalue, twin.min_eigenvalue]})
            return res

        self.trk.track_frame, self.tk.track_step, self.trk.so3_expmap = frame, step, expmap

    def uninstall(self):
        self.trk.track_frame, self.tk.track_step, self.trk.so3_expmap = self.orig


def track_scales(args, kwargs):
    """Each packed part's own scale for ``track_check``: the largest sum of
    the magnitudes of its terms (N: |J_a| w |J_b|, g: |J_a| w |r|, the
    residual: |r| over the count), in float64 from the twin's per-row SDF
    and gradient.  g is a sum of terms of both signs, so its entries can be
    far smaller than the terms whose rounding they carry."""
    import torch

    from pin_slam_torch.ops.transforms import _cross
    from pin_slam_torch.slam import tracker_grad as tg

    cache, lm, mc, decoder, sdf_scale, source, valid, R, t, _, tc = args
    nrm, nv = kwargs.get("source_normals"), kwargs.get("source_normal_valid")
    with torch.no_grad():
        cur = source @ R.to(source.device).T + t.to(source.device)
        sdf, grad, nn, std = tg.sdf_value_and_grad_cached(
            cache, lm, mc, decoder, sdf_scale, cur + lm.origin, kwargs.get("after_pgo", False))
        cur, sdf, grad = cur.double(), sdf.double(), grad.double()
        gn = torch.linalg.norm(grad, dim=-1)
        mask = (valid & (nn >= tc.mask_min_nn_count) & (gn > tc.min_grad_norm)
                & (gn < tc.max_grad_norm) & (std < tc.surface_sample_range * tc.max_sdf_std_ratio))

        def gm(k, r):
            return (k / (k * k + r * r)) ** 2

        w = gm(tc.GM_dist, sdf) * gm(tc.GM_grad, gn - 1.0)
        if nrm is not None:
            n_w = nrm.double() @ R.to(source.device).double().T
            wn = 0.5 + torch.abs(torch.sum(n_w * grad / gn.clamp(min=1e-12)[:, None], dim=-1))
            w = w * (wn if nv is None else torch.where(nv, wn, torch.ones_like(wn)))
        w = torch.where(mask, w, torch.zeros_like(w))
        count = max(int(mask.sum()), 1)
        w = w / max(2.0 * float(w.sum()) / count, 1e-12)
        J = torch.cat([_cross(cur, grad), grad], dim=-1).abs()
        Jw = J * w[:, None]
        return {"N": float((J.T @ Jw).max()), "g": float((Jw.T @ sdf.abs()).max()),
                "res_cm": float(torch.where(mask, sdf.abs(), 0.0).sum()) / count * 100.0}


def track_check(out_k, out_p, label, scales, exact=None, by_float64=False):
    """Fails unless the kernel's packed vector matches the twin's: N, g and
    the residual within ``TRACK_TOL`` of their own scale (``track_scales``),
    the valid count and the photometric count exact.  ``exact()``, where
    given, is the twin in float64: a failure reports both versions'
    distances to it; with ``by_float64`` (random inputs, where a row's IDW
    gradient can cancel far past float32's reach) a part past the tolerance
    still passes when the kernel is no farther from the twin than the twin
    is from float64.  Returns each part's largest error over its scale."""
    parts = {"N": slice(0, 36), "g": slice(36, 42), "res_cm": slice(42, 43)}
    a, b = out_k.detach().double().cpu(), out_p.detach().double().cpu()
    if a.shape != (45,) or b.shape != (45,) or not bool(a.isfinite().all()):
        fail(f"track_step[{label}]: packed vectors {tuple(a.shape)} / {tuple(b.shape)}, "
             f"finite {bool(a.isfinite().all())}")
    errs, x = {}, None
    for name, sl in parts.items():
        errs[name] = float((a[sl] - b[sl]).abs().max()) / max(scales[name], 1e-30)
        if errs[name] <= TRACK_TOL:
            continue
        if exact is None:
            fail(f"track_step[{label}]: {name} off by {errs[name]:.3g} of its scale "
                 f"(tolerance {TRACK_TOL})")
        x = exact().detach().cpu() if x is None else x
        twin64 = float((b[sl] - x[sl]).abs().max()) / max(scales[name], 1e-30)
        if not (by_float64 and errs[name] <= twin64):
            kern64 = float((a[sl] - x[sl]).abs().max()) / max(scales[name], 1e-30)
            fail(f"track_step[{label}]: {name} off by {errs[name]:.3g} of its scale "
                 f"(tolerance {TRACK_TOL}); to float64: kernel {kern64:.3g}, twin {twin64:.3g}")
    if a[43] != b[43] or a[44] != b[44]:
        fail(f"track_step[{label}]: valid count {float(a[43])} / {float(b[43])}, photometric "
             f"count {float(a[44])} / {float(b[44])}")
    return errs


def synthetic_track_args(wf, N, M, k, seed, device="cuda", n_valid=None, F=8, H=64,
                         after_pgo=False, normals=False, ties=False, layer_norm=False,
                         origin=(1234.5, -876.25, 12.75)):
    """A track step's arguments on random inputs shaped like a trained map's:
    N source rows of which the first ``n_valid`` are valid, each with M
    cached candidates within 0.6 m of its point (a sixth of them not in the
    map), each candidate a map row of its own whose features vary smoothly
    with its position (0.5 sin of a random linear field, plus noise of
    0.02), so that the
    neighbours' predictions agree as a trained map's do; near-identity
    quaternions (a pose-graph correction); features with a certainty column
    beside them, as the map stores them; a decoder of F + 3 -> H -> 1 scaled
    so that the median gradient norm is 1.  ``ties``: candidate columns 2,
    4, ... repeat the position of the column before them with another row
    (so the k-th and (k+1)-th nearest are often a tie).  ``origin``: the
    local map's, by default a kilometre out, as the cells' maps are.
    Returns the ``track_step`` positional arguments (origin among them) and
    keywords."""
    import types

    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam import tracker_grad as tg
    from pin_slam_torch.slam.tracker import TrackerConfig

    g = torch.Generator().manual_seed(seed)
    n_valid = N if n_valid is None else n_valid
    L = N * M
    origin = torch.tensor(origin)
    ang = torch.rand(3, generator=g) * 0.2 - 0.1
    R = torch.linalg.matrix_exp(torch.tensor([[0.0, -ang[2], ang[1]], [ang[2], 0.0, -ang[0]],
                                              [-ang[1], ang[0], 0.0]]))
    t = torch.rand(3, generator=g) - 0.5
    source = torch.rand((N, 3), generator=g) * 20.0 - 10.0
    valid = torch.arange(N) < n_valid
    p = source @ R.T + t + origin
    pos = p[:, None, :] + torch.rand((N, M, 3), generator=g) * 1.2 - 0.6
    if ties:
        pos[:, 2:M - 1:2] = pos[:, 1:M - 2:2]
    lidx = torch.arange(L).reshape(N, M)
    feat = torch.zeros((L + 1, F + 1))
    field, phase = torch.randn((3, F), generator=g) * 0.5, torch.rand(F, generator=g) * 6.3
    feat[:L, :F] = (0.5 * torch.sin((pos - origin).reshape(L, 3) @ field + phase)
                    + torch.randn((L, F), generator=g) * 0.02)
    attr = torch.zeros((L + 1, npts.ATTR_DIM))
    attr[:L, :3] = pos.reshape(L, 3)
    q = torch.cat([torch.ones((L + 1, 1)), torch.randn((L + 1, 3), generator=g) * 0.05], 1)
    attr[:, 3:7] = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    attr[L, 3:7] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    out = torch.rand((N, M), generator=g) < 1.0 / 6.0
    lidx = torch.where(out, torch.full_like(lidx, L), lidx)
    pos = torch.where(out[..., None], torch.full_like(pos, 1e5), pos)
    cache = tg.CandCache(xs=pos[..., 0].contiguous(), ys=pos[..., 1].contiguous(),
                         zs=pos[..., 2].contiguous(), lidx=lidx)
    mc = npts.MapConfig(capacity=L, local_capacity=L, hash_size=1 << 12, voxel_size=0.4,
                        feature_dim=F, nn_k=k, max_valid_dist2=0.75 ** 2 * 3 / 4,
                        local_map_radius=50.0, travel_dist_window=100.0, weighted_first=wf,
                        layer_norm_on=layer_norm)
    decoder = Decoder(F + 3, H, 1, 1, generator=g).requires_grad_(False)
    nrm = nv = None
    if normals:
        nrm = torch.randn((N, 3), generator=g)
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        nv = torch.rand(N, generator=g) < 0.8
    lm = types.SimpleNamespace(geo_features=feat[:, :F], attr_rows=attr, origin=origin)
    # the decoder's scale: the median gradient norm of the valid rows at 1;
    # the spread gate at twice the median spread
    _, grad, _, std = tg.sdf_value_and_grad_cached(cache, lm, mc, decoder, 1.0, p, after_pgo)
    gn = torch.linalg.norm(grad[:max(n_valid, 1)], dim=-1)
    scale = 1.0 / max(float(gn.median()), 1e-6)
    std_ratio = max(2.0 * scale * float(std[:max(n_valid, 1)].median()) / 0.25, 1.0)
    tc = TrackerConfig(mask_min_nn_count=min(k, 6), max_sdf_std_ratio=std_ratio)

    def dev(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x

    decoder = decoder.to(device)
    feat_d, attr_d = feat.to(device), attr.to(device)
    lm = types.SimpleNamespace(geo_features=feat_d[:, :F], attr_rows=attr_d,
                               origin=origin.to(device))
    cache = tg.CandCache(*(dev(x) for x in cache))
    args = [cache, lm, mc, decoder, scale, dev(source), dev(valid), R, t, origin, tc]
    return args, dict(after_pgo=after_pgo, source_normals=dev(nrm), source_normal_valid=dev(nv))


def _plain64_of(args, kwargs):
    """The twin's call in float64 on the same inputs (for a failure's
    report: each float32 version's distance to it)."""
    import copy
    import types

    import torch

    from pin_slam_torch.ops import track_kernel

    def d(x):
        return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x

    cache, lm, mc, decoder, sdf_scale, source, valid, R, t, _, tc = args
    lm64 = types.SimpleNamespace(geo_features=d(lm.geo_features), attr_rows=d(lm.attr_rows),
                                 origin=d(lm.origin))
    return lambda: track_kernel.track_step_plain(
        cache._make(d(x) for x in cache), lm64, mc, copy.deepcopy(decoder).double(), sdf_scale,
        d(source), valid, d(R), d(t), tc, **{k: d(v) for k, v in kwargs.items()})


def _plain_of(args, kwargs):
    """The twin's call on ``track_step``'s arguments (it reads the origin
    from the map)."""
    from pin_slam_torch.ops import track_kernel

    return lambda: track_kernel.track_step_plain(*args[:9], *args[10:], **kwargs)


def track_bound(args, kwargs):
    """(least ms, what bounds it) of one step: the valid rows' source row,
    flag and M candidates (xyz, int64 index), their k neighbours' feature
    rows (and quaternions after a pose-graph optimisation, normals where
    given), the decoder and the packed vector; operations of k decodes a row
    per neighbour (the forward, its output, the 3-wide input gradient), or
    one decode and its full input gradient with weighted_first."""
    cache, lm, mc, decoder, _, source, valid = args[:7]
    n = int(valid.sum())
    M = cache.lidx.shape[1]
    k = min(mc.nn_k, M)
    F = lm.geo_features.shape[1]
    W1 = decoder.layers()[0][0]
    IN, H = W1.shape
    row = 12 + 1 + M * 20 + k * 4 * (F + (4 if kwargs.get("after_pgo") else 0))
    row += 13 if kwargs.get("source_normals") is not None else 0
    nbytes_ = n * row + 4 * (IN * H + 2 * H + 1) + 4 * 45
    if mc.weighted_first:
        flops = n * (2 * IN * H + 2 * H + 2 * IN * H + 2 * k * IN)
    else:
        flops = n * k * (2 * IN * H + 2 * H + 2 * 3 * H)
    return bound(nbytes_, flops)


def track_step_phase(label, args, kwargs, launches):
    """A kernel row of the track step on one captured (or random) input:
    checked against the twin, two launches bit-identical, timed."""
    import torch

    from pin_slam_torch.ops import track_kernel

    def kern():
        return track_kernel.track_step(*args, **kwargs)

    cache, lm, mc, decoder = args[:4]
    with torch.no_grad():
        plain = _plain_of(args, kwargs)
        errs = track_check(kern(), plain(), label, track_scales(args, kwargs),
                           _plain64_of(args, kwargs))
        identical_check(kern(), kern(), f"track_step[{label}]")
        times = timings(kern, plain)
    bms, what = track_bound(args, kwargs)
    row = {"name": f"track_step[{label}]", "route": "cuda", "launches": launches,
           "shape": {"N": int(args[5].shape[0]), "valid": int(args[6].sum()),
                     "M": int(cache.lidx.shape[1]), "k": min(mc.nn_k, cache.lidx.shape[1]),
                     "F": int(lm.geo_features.shape[1]), "H": int(decoder.layers()[0][0].shape[1]),
                     "weighted_first": bool(mc.weighted_first),
                     "after_pgo": bool(kwargs.get("after_pgo")),
                     "normals": kwargs.get("source_normals") is not None,
                     "layer_norm": bool(mc.layer_norm_on)},
           "grid": track_kernel.track_grid(int(args[5].shape[0]), args[5].get_device()),
           "err_vs_plain": errs, "bound_ms": bms, "bound_by": what, **times}
    emit({"phase": "kernel", **row})
    return row


def track_edge_phase():
    """The track step on random inputs: at the cells' shape on a map a
    kilometre out (where one ulp of a point is 1e-3 of an offset, so only a
    point formed as the twin forms it passes) in both modes with and without
    after_pgo and normals, held to ``TRACK_TOL``; then near the world's
    origin at every decoder width class x both modes x k / M / N edges, with
    and without after_pgo, normals, ties and layer norm (``track_check``
    with ``by_float64``: a few random rows can cancel past float32's
    reach).  Two launches bit-identical in every case."""
    import torch

    from pin_slam_torch.ops import track_kernel

    def case(label, args, kw, by_float64):
        out = track_kernel.track_step(*args, **kw)
        e = track_check(out, _plain_of(args, kw)(), label, track_scales(args, kw),
                        _plain64_of(args, kw), by_float64=by_float64)
        identical_check(out, track_kernel.track_step(*args, **kw), label)
        return max(e.values())

    errs, cases = {}, 0
    with torch.no_grad():
        for wf in (True, False):
            for extra in ({}, {"after_pgo": True, "normals": True}):
                args, kw = synthetic_track_args(wf, 16384, 16, 6, 90 + cases, n_valid=3300,
                                                **extra)
                key = f"far wf{int(wf)}"
                errs[key] = max(errs.get(key, 0.0),
                                case(f"far wf{int(wf)} {sorted(extra)}", args, kw, False))
                cases += 1
        for F, H in TRACK_EDGE_WIDTHS:
            for wf in (True, False):
                for k, M in ((1, 16), (6, 16), (8, 32), (16, 16)):
                    for N, n_valid in ((1, 1), (37, 30), (16384, 3300)):
                        c = cases
                        args, kw = synthetic_track_args(
                            wf, N, M, k, 100 + c, n_valid=n_valid, F=F, H=H,
                            after_pgo=c % 2 == 1, normals=c % 3 == 1, ties=c % 4 == 2,
                            layer_norm=c % 5 == 3, origin=(12.5, -4.25, 1.75))
                        key = f"F{F}-H{H}"
                        errs[key] = max(errs.get(key, 0.0), case(
                            f"edge F{F} H{H} wf{int(wf)} k{k} M{M} N{N}", args, kw, True))
                        cases += 1
    emit({"phase": "track_edges", "cases": cases, "max_err_over_scale": errs,
          "tolerance": TRACK_TOL})


def track_decisions(twin):
    """The whole-frame comparison: every tracked frame of every path, run
    with the kernel and again with its twin, must give the same iterations,
    validity and convergence.  A flip is reported with its margins (each
    run's stop ratio at the deciding iteration, the final poses' distance
    over the stop thresholds, both residuals, valid counts and least
    eigenvalues); it fails the run unless both runs registered and
    converged one iteration apart, ending closer than one stop step (0.5 mm,
    0.01 deg) to each other: a slowly converging registration whose last
    steps sit at the threshold, not a different registration."""
    frames = {path: len(v) for path, v in twin.frames.items()}
    emit({"phase": "track_step", "frames_compared": frames, "flips": twin.flips,
          "replay_s": twin.replay_s})
    if not frames:
        fail("track_step: no tracked frame launched the kernel")
    bad = [f for f in twin.flips if not f["same_registration"]]
    if bad:
        fail(f"track_step: {len(bad)} tracked frame(s) decided otherwise with the twin: "
             f"{bad[:3]}")


# ----------------------------------------------------------------------
# the replay pool's re-derivation after a pose change (ops/pool_kernel.py)
# ----------------------------------------------------------------------

POOL_CELLS = ("kitti_hdl64.loop", "ncd_os0_128.quad")
POOL_SETUP_FRAMES = 60
POOL_SEED = 3923500081
# the kernel against its plain twin, by the columns it writes.  Coordinates:
# the twin's 3-term product runs in a batched GEMM (its order and fused
# multiply-adds are the library's), the kernel's as one FMA chain; either
# rounds each term at most twice, so 4 ulps of the pool's largest
# coordinate.  The rest is held against the twin's refresh of the kernel's
# own coordinates (one ulp of a 100 m coordinate, 7.6e-6 m, would move a
# weight at a 1 mm offset by 1 %): weights 1e-6 (8 ulps of 1: the twin sums
# the k inverse distances in a reduction's order, then divides); offset
# vectors 1e-5 m (offsets are below sqrt(max_valid_dist2), 1.6 m; the
# rotation's terms are below 3 |v|, so 1e-5 is 20 ulps of 4.7 m; the
# library's cross product and the blend's GEMM may fuse what the kernel
# rounds apart).  Every other column keeps its bits; rows past the fill are
# the twin's.
POOL_COORD_ULPS = 4
POOL_TOL = {"weights": 1e-6, "blend": 1e-5, "per_neighbour": 1e-5}


def pool_groups(k, width):
    """{written column group: its columns} of a pool row of ``width``
    floats at k neighbours (``mapper.pool_layout``)."""
    groups = {"coord": slice(0, 3), "weights": slice(9 + k, 9 + 2 * k),
              "blend": slice(9 + 2 * k, 12 + 2 * k)}
    if width > 12 + 2 * k:
        groups["per_neighbour"] = slice(12 + 2 * k, width)
    return groups


def pool_check(out, twin, refresh, before, k, fill, label):
    """Fails unless the kernel's rows ``out`` hold coordinates within
    ``POOL_COORD_ULPS`` ulps of the pool's largest coordinate of the twin's
    (``twin``: the plain twin's rows), every other written column within
    ``POOL_TOL`` of ``refresh`` (the twin's refresh of ``out``'s own
    coordinates), the columns the pass does not own (3 .. 8 + k: label,
    weight, frame id, sensor-frame coordinates, neighbour ids) bit-identical
    to ``before``, and rows from ``fill`` on equal to the twin's.  Returns
    {group: {"err", "tol", "err_vs_twin"}} and the share of rows whose
    coordinates carry the twin's bits."""
    import torch

    groups = pool_groups(k, out.shape[1])
    scale = float(twin[:, :3].abs().max())
    tol_c = POOL_COORD_ULPS * 2.0 ** (float(np.floor(np.log2(max(scale, 1e-30)))) - 23)
    res = {}
    for g, cols in groups.items():
        ref = twin if g == "coord" else refresh
        err = float((out[:, cols] - ref[:, cols]).abs().max())
        tol = tol_c if g == "coord" else POOL_TOL[g]
        res[g] = {"err": err, "tol": tol,
                  "err_vs_twin": float((out[:, cols] - twin[:, cols]).abs().max())}
        if not err <= tol:
            fail(f"{label}: column group {g} off its reference by {err} (tolerance {tol})")
    own = slice(3, 9 + k)
    if not torch.equal(out[:, own].contiguous().view(torch.int32),
                       before[:, own].contiguous().view(torch.int32)):
        fail(f"{label}: a column the pass does not own changed")
    if not torch.equal(out[fill:], twin[fill:]):
        fail(f"{label}: rows past the fill ({fill}) differ from the twin's")
    same = (out[:, :3].view(torch.int32) == twin[:, :3].view(torch.int32)).all(1)
    return res, float(same.to(torch.float64).mean())


def pool_bound(rows, attr, k, fill):
    """(bound ms, what bounds it, the gathers' ms were every valid
    neighbour of a live row a 32-byte sector from device memory, the live
    rows' valid neighbour count, distinct neighbours): the rows read and
    written once, the distinct neighbours' position and quaternion (28 B)
    read once; operations 18 a row (the coordinates) and 49 a neighbour."""
    import torch

    ids = rows[:fill, 9:9 + k].to(torch.int64)
    live = ids[ids >= 0].clamp(max=attr.shape[0] - 1)
    n_valid, n_distinct = int(live.numel()), int(torch.unique(live).numel())
    ms, by = bound(2 * nbytes(rows) + 28 * n_distinct, rows.shape[0] * (18 + 49 * k))
    return ms, by, 32 * n_valid / H100_BYTES_PER_S * 1e3, n_valid, n_distinct


def _rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def synthetic_pool_args(k, wf, n, seed, device="cuda", cap=4096, T=40):
    """(pool, poses, attribute rows, map configuration) of a random pool of
    n rows, the last fifth past the fill: live rows near clusters of 8 map
    points, a tenth of their ids -1, a tenth another cluster's point (past
    max_valid_dist2), a few the sentinel or past it, a few frame ids -1,
    every 50th live row without a neighbour; rotated quaternions."""
    import types

    import torch

    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.slam import mapper as mp

    rng = np.random.default_rng(seed)
    width = 12 + 2 * k + (0 if wf else 3 * k)
    fill = n * 4 // 5
    poses = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    for f in range(T):
        poses[f, :3, :3] = _rot(np.concatenate([[1.0], rng.normal(0, 0.15, 3)]))
        poses[f, :3, 3] = rng.uniform(-50, 50, 3)
    n_cl = (cap - 8) // 8
    centre = rng.uniform(-50, 50, (n_cl, 3))
    pos = (centre[:, None, :] + rng.normal(0, 0.25, (n_cl, 8, 3))).reshape(-1, 3)
    attr = np.zeros((cap + 1, npts.ATTR_DIM), np.float32)
    attr[:, 3] = 1.0
    attr[:len(pos), :3] = pos
    q = np.concatenate([np.ones((len(pos), 1)), rng.normal(0, 0.1, (len(pos), 3))], 1)
    attr[:len(pos), 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    attr[cap, :3] = 1e8
    rows = np.zeros((n, width), np.float32)
    rows[:, 9:9 + k] = -1.0
    cl, ts = rng.integers(0, n_cl, fill), rng.integers(0, T, fill)
    target = centre[cl] + rng.normal(0, 0.3, (fill, 3))
    R, t = poses[ts, :3, :3].astype(np.float64), poses[ts, :3, 3].astype(np.float64)
    ids = cl[:, None] * 8 + np.stack([rng.permutation(8)[:k] for _ in range(fill)])
    u = rng.uniform(size=(fill, k))
    ids = np.where(u < 0.1, -1, ids)
    ids = np.where((u >= 0.1) & (u < 0.2), rng.integers(0, len(pos), (fill, k)), ids)
    ids = np.where(u > 0.995, cap + rng.integers(0, 3, (fill, k)), ids)
    ids[::50] = -1
    rows[:fill, 5] = np.where(rng.uniform(size=fill) < 0.02, -1, ts)
    rows[:fill, 6:9] = np.einsum("nji,nj->ni", R, target - t)
    rows[:fill, 9:9 + k] = ids
    rows[:fill, 3:5] = rng.normal(size=(fill, 2))
    rows[:fill, :3] = rng.normal(size=(fill, 3))
    rows[:fill, 9 + k:] = rng.normal(size=(fill, width - 9 - k))
    z = torch.zeros((), dtype=torch.int64, device=device)
    pool = mp.PoolState(rows=torch.as_tensor(rows, device=device), head=z + fill,
                        fill=z + fill, new_idx=torch.zeros((4,), dtype=torch.int64,
                                                           device=device), new_count=z)
    mc = types.SimpleNamespace(capacity=cap, nn_k=k, max_valid_dist2=1.08)
    return pool, torch.as_tensor(poses, device=device), torch.as_tensor(attr, device=device), mc


def pool_compare(pool, poses, attr, mc, label):
    """The kernel's pass (twice) and the plain twin's on copies of
    ``pool``; ``pool_check`` and the two launches' bits.  Returns the
    check's result, the kernel's and the twin's rows."""
    import dataclasses as dc

    import torch

    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import pool_kernel as pk
    from pin_slam_torch.slam import mapper as mp

    before = pool.rows.clone()
    k, fill = mc.nn_k, int(pool.fill)
    n0 = _cuda.COUNTS["pool_pass"]
    out = pk.pool_pass(dc.replace(pool, rows=before.clone()), poses, attr, mc).rows
    again = pk.pool_pass(dc.replace(pool, rows=before.clone()), poses, attr, mc).rows
    if _cuda.COUNTS["pool_pass"] != n0 + 2:
        fail(f"{label}: the pool pass did not launch its kernel")
    twin = pk.pool_pass_plain(dc.replace(pool, rows=before.clone()), poses, attr, mc).rows
    refresh = mp.pool_refresh_cache(dc.replace(pool, rows=out.clone()), attr, mc).rows
    torch.cuda.synchronize()
    identical_check(out, again, label)
    res = pool_check(out, twin, refresh, before, k, fill, label)
    del again, refresh
    return res, before, out, twin


def pool_pass_phase(cell):
    """The pool pass at a cell's pool after a real set-up: the cell's
    configuration and generator, ``POOL_SETUP_FRAMES`` frames through the
    program, then per-frame pose corrections (0.02 rad, 0.2 m) applied to
    the pose books and, by ``adjust_map``, to the map (rotated
    quaternions).  The kernel against its plain twin (``pool_check``),
    both timed (``ms`` / ``dev`` as the kernel table's; the twin is the
    parent's two calls, chunked), the bound at the pool's fill.  Returns the
    kernels line's row."""
    import dataclasses as dc

    import torch

    from pin_slam_torch.dataset.slam_dataset import SLAMDataset
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops import pool_kernel as pk
    from pin_slam_torch.slam.pipeline import TS_CAPACITY, SlamSystem
    from slambench import harness

    dev = torch.device("cuda")
    spec = harness.load_cell(cell)
    cfg = harness.build_config(spec, POOL_SEED)
    gen = harness.traffic_module("generators", spec.traffic["generator"]).make(
        spec.config["sensor"], spec.traffic, POOL_SEED, dev)
    seq = gen.sequence(POOL_SETUP_FRAMES)
    ds = SLAMDataset(cfg, scans=seq.scans, gt_poses=seq.gt_poses, device=dev)
    system = SlamSystem(cfg, dataset=ds, device=dev)
    t0 = time.perf_counter()
    for i in range(POOL_SETUP_FRAMES):
        system.process_frame(ds.preprocess_frame(i))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mc, pool = system.mc, system.pool
    books = np.stack(harness.pose_books(system)).astype(np.float32)
    rng = np.random.default_rng(POOL_SEED)
    diff = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
    for f in range(len(books)):
        diff[f, :3, :3] = _rot(np.concatenate([[1.0], rng.normal(0, 0.01, 3)]))
        diff[f, :3, 3] = rng.normal(0, 0.2, 3)
    poses = np.tile(np.eye(4, dtype=np.float32), (TS_CAPACITY, 1, 1))
    poses[:len(books)] = diff[:len(books)] @ books
    poses = torch.as_tensor(poses, device=dev)
    attr = npts.adjust_map(system.state, mc, torch.as_tensor(diff, device=dev)).attr_rows
    label = f"pool_pass[{cell}]"
    (res, same), before, out, twin = pool_compare(pool, poses, attr, mc, label)
    k, fill = mc.nn_k, int(pool.fill)
    b_ms, b_by, gather_ms, n_valid, n_distinct = pool_bound(before, attr, k, fill)
    del twin
    work = dc.replace(pool, rows=out)
    t = timings(lambda: pk.pool_pass(work, poses, attr, mc),
                lambda: pk.pool_pass_plain(work, poses, attr, mc))
    row = {"kernel": "pool_pass", "path": cell, "label": label,
           "shape": {"rows": before.shape[0], "width": before.shape[1], "k": k,
                     "weighted_first": before.shape[1] == 12 + 2 * k, "fill": fill,
                     "attr_rows": attr.shape[0], "poses": poses.shape[0],
                     "valid_neighbours": n_valid, "distinct_neighbours": n_distinct},
           "setup_frames": POOL_SETUP_FRAMES, "setup_s": setup_s,
           "bound_ms": b_ms, "bound_by": b_by, "gather_sectors_ms": gather_ms, **t,
           "x_bound": t["device_ms"] / b_ms, "errors": res, "coord_bits_equal_share": same,
           "tolerance": {"coord_ulps": POOL_COORD_ULPS, **POOL_TOL}}
    emit({"phase": "pool_pass", **row})
    del system, work, out, before, attr
    torch.cuda.empty_cache()
    return row


def pool_edge_phase():
    """Every instantiation of the pool-pass kernel (k 1..8, both layouts)
    against the plain twin on random pools whose row counts leave a partial
    tile and a tail of fewer than 4 floats; a misaligned view of the rows
    refused."""
    import dataclasses as dc

    import torch

    from pin_slam_torch.ops import pool_kernel as pk

    cases, worst = 0, {}
    for k in range(1, pk.MAX_K + 1):
        for wf in (True, False):
            n = 1001 + 2 * k + int(wf)
            pool, poses, attr, mc = synthetic_pool_args(k, wf, n, 100 + k, "cuda")
            (res, _), *_ = pool_compare(pool, poses, attr, mc, f"pool_edges[k{k}-wf{int(wf)}]")
            for g, r in res.items():
                worst[g] = max(worst.get(g, 0.0), r["err"] / r["tol"])
            cases += 1
    pool, poses, attr, mc = synthetic_pool_args(6, False, 1001, 7, "cuda")
    flat = torch.zeros(pool.rows.numel() + 1, device="cuda")
    bad = flat[1:].view(pool.rows.shape)
    try:
        pk.pool_pass(dc.replace(pool, rows=bad), poses, attr, mc)
        fail("pool_edges: a misaligned view of the rows was not refused")
    except ValueError:
        pass
    emit({"phase": "pool_edges", "cases": cases, "max_err_over_tol": worst})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pin_slam_torch")):
        print("chip_smoke: pin_slam_torch/ not found next to chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    from pin_slam_torch.ops import _cuda

    t0 = time.perf_counter()
    secs = _cuda.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": secs})

    cap = Capture()
    cap.install()
    cap.twin = TrackTwin(cap)
    cap.twin.install()
    try:
        results = {name: run_path(name, cap, mesh=True) for name in PATHS}
        results["D"] = run_path_d(cap)
        results["E"] = run_path_e(cap)
        results["F"] = run_path_f(cap)
        results["G"] = run_path_g(cap)
        results["I"] = run_path_i(cap)
        exact = {name: exact_phase(name, cap) for name in EXACT_PHASES}
        egen_phase(cap)
        _, live_npz = live_c_phase(cap)
    finally:
        cap.twin.uninstall()
        cap.uninstall()
    track_decisions(cap.twin)
    vis_pin_map_phase(live_npz)
    cli_kitti_phase()
    train_general_phase()
    dp_nccl1_phase()
    _, dp_rows = dp_b_phase()
    _, shard_rows = shard_c_phase(results["C"]["map_points"])

    rows = []
    for path, res in results.items():
        tag = f"path{path}" if len(path) == 1 else path
        for kind in ("far", "near"):
            key = (path, "rank_brick", kind)
            if key not in cap.inputs:
                fail(f"path {path}: no {kind} rank launch captured")
            rows.append(rank_brick_phase(f"{tag}-{kind}", cap.inputs[key][0],
                                         cap.tally[key]))
        # path F trains by autograd: no training kernel on it
        if (path, "train_iter", "main") in cap.inputs:
            a, kw = cap.inputs[(path, "train_iter", "main")]
            rows.append(train_phase(tag, a, kw, res["launches"]["train_iter"]))
            a, kw = cap.inputs[(path, "eikonal", "main")]
            rows.append(eik_phase(tag, a, kw, res["launches"]["eikonal"]))
        # path E's colour head adds the colour labels' gather (once a
        # training call), the colour features' gather and their gradient's
        # scatter (once an iteration each)
        for kind in ("pool", "feat", "color", "label"):
            if (path, "gather", kind) in cap.inputs:
                a, kw = cap.inputs[(path, "gather", kind)]
                rows.append(gather_phase(f"{tag}-{kind}", a, kw,
                                         cap.tally.get((path, "gather", kind), 0)))
        (frame_idx, _), _ = cap.inputs[(path, "plans", "frame")]
        # the training loop's launches (path D's bundle adjustment has its own
        # row; on path F the autograd loop's feature gradient, as "-sem")
        for kind, suffix in (("main", "-sem" if path == "F" else ""), ("color", "-color")):
            if (path, "scatter", kind) in cap.inputs:
                (n_rows, idx, val), kw = cap.inputs[(path, "scatter", kind)]
                rows.append(scatter_phase(f"{tag}{suffix}", n_rows, idx, val,
                                          kw.get("plan"), kw.get("skip_row"),
                                          cap.tally.get((path, "scatter", kind), 0), frame_idx))
        for kernel, kinds in (("rank_brick", ("far", "near")),
                              ("gather", ("pool", "feat", "ba", "color", "label")),
                              ("scatter", ("main", "ba", "color"))):
            if sum(cap.tally.get((path, kernel, x), 0) for x in kinds) != res["launches"][kernel]:
                fail(f"path {path}: {kernel} launch tallies disagree with the counter")
    # the exact-kNN loop's row kernels: the pool rows' gather once a call,
    # the feature rows' gather and their gradient's scatter once an
    # iteration, the certainty sum once a call
    for name in exact:
        for kind in ("pool", "feat"):
            a, kw = cap.inputs[(name, "gather", kind)]
            rows.append(gather_phase(f"{name}-{kind}", a, kw,
                                     cap.tally[(name, "gather", kind)]))
        (frame_idx, _), _ = cap.inputs[(name, "plans", "frame")]
        for kind, suffix in (("main", ""), ("cert", "-cert")):
            (n_rows, idx, val), kw = cap.inputs[(name, "scatter", kind)]
            rows.append(scatter_phase(f"{name}{suffix}", n_rows, idx, val, kw.get("plan"),
                                      kw.get("skip_row"), cap.tally[(name, "scatter", kind)],
                                      frame_idx if kind == "main" else None))
    # Egen: the autograd loop's feature and colour rows (gather forward,
    # in-order scatter backward), once an iteration each
    for kind in ("feat", "color"):
        a, kw = cap.inputs[("Egen", "gather", kind)]
        rows.append(gather_phase(f"Egen-{kind}", a, kw, cap.tally[("Egen", "gather", kind)]))
    (frame_idx, _), _ = cap.inputs[("Egen", "plans", "frame")]
    for kind, suffix in (("main", ""), ("color", "-color")):
        (n_rows, idx, val), kw = cap.inputs[("Egen", "scatter", kind)]
        rows.append(scatter_phase(f"Egen{suffix}", n_rows, idx, val, kw.get("plan"),
                                  kw.get("skip_row"), cap.tally[("Egen", "scatter", kind)],
                                  frame_idx))
    # bundle adjustment's shapes on path D: the feature gather (forward) and
    # the in-order scatter of its gradient (backward), one each an iteration
    a, kw = cap.inputs[("D", "gather", "ba")]
    rows.append(gather_phase("pathD-ba", a, kw, results["D"]["ba_gather_launches"]))
    (n_rows, idx, val), kw = cap.inputs[("D", "scatter", "ba")]
    rows.append(scatter_phase("pathD-ba", n_rows, idx, val, kw.get("plan"),
                              kw.get("skip_row"), results["D"]["ba_scatter_launches"]))
    # the per-rank shapes of dp_B and the rank kernel under shard_C, each
    # held to its plain twin inside the child that captured it
    rows += dp_rows + shard_rows
    # the tracker's step on each path's capture frame: A weighted_first, B
    # per neighbour at the cells' shape, C after the pose-graph optimisation,
    # F with normals, G at k = 8
    for path in ("A", "B", "C", "F", "G"):
        if path not in cap.twin.inputs:
            fail(f"path {path}: no track-step launch captured")
        a, kw = cap.twin.inputs[path]
        rows.append(track_step_phase(f"path{path}", a, kw,
                                     results[path]["launches"]["track_step"]))
    # the pool's pass after a pose change, at each pool-pass cell's pool
    for cell in POOL_CELLS:
        rows.append(pool_pass_phase(cell))
    # k = 8 (which the JAX kernels cannot run): checked and timed on random
    # inputs at the main path's widths; not a main-path shape, so these rows
    # stay out of the kernels line
    for wf in (True, False):
        train_phase(f"k8-wf{int(wf)}", synthetic_train_args(wf, 16384, 8, 1), {}, 0)
        eik_phase(f"k8-wf{int(wf)}", synthetic_eik_args(wf, 1638, 8, 2), {}, 0)
    experiment_shape_rows()
    rank_cells_phase()
    rank_edge_phase()
    train_edge_phase()
    eikonal_edge_phase()
    width_edge_phase()
    track_edge_phase()
    gather_edge_phase()
    scatter_edge_phase()
    pool_edge_phase()

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
