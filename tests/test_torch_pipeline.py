"""The port's main path as a whole (pin_slam_torch.slam.pipeline.SlamSystem,
odometry + mapping fast path, PGO off) against the JAX package's
SlamSystem on a tiny synthetic scene, in both interpolation modes; plus the
port's import hygiene and its refusal to fall back to the CPU silently.

Both systems consume the same random draws: the port's RandomSource is
replaced by one that recreates the JAX package's threefry draws from the
keys its pipeline splits.  Before every frame the port's state (map, local
map, pool, decoder, pose books) is set from the JAX system's, so each
frame's comparison sees identical inputs: the training loop amplifies
float32 rounding differences (Adam with eps 1e-15 turns a sign flip of a
near-zero gradient into a full step), and on this tiny scene a 1e-7
relative change of the initial decoder moves a free-running trajectory by
several centimetres within five frames, in either package."""

import ast
import copy
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1 << 13


class JaxDraws:
    """The JAX SlamSystem's random draws, per frame (pipeline.py key splits:
    per frame ``key, k_frame, k_train = split(key, 3)``; sampling from
    ``split(k_frame)[1]``, the training batch from ``split(k_frame)[0]``,
    frame-0 extra chunks from ``fold_in(k_train, chunk)``)."""

    def __init__(self, seed, jmcfg):
        from pin_slam_tpu.slam import mapper as jmp

        self.jmp, self.jmcfg = jmp, jmcfg
        self.key0 = jax.random.split(jax.random.PRNGKey(seed), 4)[0]

    def _frame_keys(self, fid):
        k = self.key0
        for _ in range(fid + 1):
            k, k_frame, k_train = jax.random.split(k, 3)
        return k_frame, k_train

    def ray_noise(self, fid, sc, n):
        k_sample = jax.random.split(self._frame_keys(fid)[0])[1]
        k_surf, k_front, k_behind = jax.random.split(k_sample, 3)
        return tuple(torch.as_tensor(np.array(d)) for d in (
            jax.random.normal(k_surf, (n, sc.surface_sample_n)),
            jax.random.uniform(k_front, (n, sc.free_front_n)),
            jax.random.uniform(k_behind, (n, sc.free_behind_n))))

    def batch_indices(self, fid, chunk, pool, mcfg, use_new, num_iters):
        k_frame, k_train = self._frame_keys(fid)
        key = (jax.random.fold_in(k_train, chunk) if chunk >= 0
               else k_frame if chunk == -2 else jax.random.split(k_frame)[0])
        pool_j = types.SimpleNamespace(fill=jnp.int32(int(pool.fill)),
                                       new_count=jnp.int32(int(pool.new_count)),
                                       new_idx=jnp.asarray(np_(pool.new_idx).astype(np.int32)))
        idx = self.jmp._sample_batch_indices(key, pool_j, self.jmcfg, jnp.asarray(use_new),
                                             num_iters)
        return torch.as_tensor(np.array(idx), dtype=torch.int64)


def _config(Config, wf):
    cfg = Config()
    cfg.pgo_on = False
    cfg.silence = True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 17, 1 << 17
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, N_RAYS, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    cfg.weighted_first = wf
    cfg._derive()
    return cfg


def _frames(n):
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(np.random.default_rng(0))
    out = []
    for i in range(n):
        R, t = syn.sensor_pose(i)
        pts = syn.lidar_scan(rng, world, t, R, N_RAYS)
        arr, valid = pad_to(pts, N_RAYS)
        out.append((arr, valid, pts.shape[0]))
    return out


def _sync_from_jax(tsys, jsys):
    """Set the port's whole per-frame state from the JAX system's."""
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import params_from_jax
    from pin_slam_torch.slam import mapper as tm

    tsys.state = tn.state_from_numpy(jsys.state)
    tsys.lm = tn.local_map_from_numpy(jsys.lm)
    tsys.pool = tm.pool_from_numpy(jsys.pool)
    tsys.decoder.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jsys.geo_params)))
    tsys._travel = torch.as_tensor(np.array(jsys._travel))
    tsys._stop_count = int(jsys._stop_count)
    tsys.cur_pose, tsys.lm_origin64 = jsys.cur_pose.copy(), jsys.lm_origin64.copy()
    for name in ("odom_poses", "travel_dist", "last_pose", "last_odom_tran", "stop_status",
                 "lose_track", "consecutive_lose_track_frame", "stop_count", "processed_frame"):
        setattr(tsys.dataset, name, copy.deepcopy(getattr(jsys.dataset, name)))


@pytest.mark.parametrize("wf", [True, False])
def test_slice_matches_jax(wf):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import Frame as TFrame
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import Frame as JFrame
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    jsys = JSlam(_config(JConfig, wf))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    tcfg = _config(TConfig, wf)
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    tsys.tc = dataclasses.replace(tsys.tc, min_valid_ratio=0.1)

    for i, (arr, valid, n) in enumerate(_frames(5)):
        _sync_from_jax(tsys, jsys)
        j_info = jsys.process_frame(JFrame(arr, valid, None, None, None, n))
        t_info = tsys.process_frame(TFrame(arr, valid, n))
        if i > 0:
            assert j_info["reg_valid"] and t_info["reg_valid"], (i, j_info, t_info)
        assert t_info["loss_finite"] and np.isfinite(t_info["loss_last"])
        Tj, Tt = jsys.cur_pose, tsys.cur_pose
        # poses: within 2 cm / 0.2 deg of the JAX package's
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.02, (i, Tj[:3, 3], Tt[:3, 3])
        cos = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, i
        # map and pool sizes within 5%
        for a, b in ((int(tsys.state.count), int(jsys.state.count)),
                     (int(tsys.pool.fill), int(jsys.pool.fill))):
            assert abs(a - b) <= 0.05 * b, (i, a, b)


def _import_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """pin_slam_torch/ and chip_smoke.py import neither JAX, nor anything of
    the JAX package, nor bench.py, nor the JAX package's entry points
    pin_slam_ros.py and vis_pin_map.py (source scan + a clean interpreter;
    the port's own ros and vis_pin_map modules and its dataset tools are
    among those scanned)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pin_slam_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    assert {os.path.join(ROOT, "pin_slam_torch", f) for f in (
        "ros.py", "vis_pin_map.py", "utils/viewer_html.py", "utils/viewer_server.py",
        "utils/sensor_cad.py", "parallel/__init__.py", "parallel/distributed.py",
        "parallel/mesh.py", "parallel/spatial.py", "parallel/launch.py",
        "dataset/convert_dataset.py", "dataset/rosbag2ply.py")} <= set(files)
    banned = ("jax", "jaxlib", "pin_slam_tpu", "bench", "optax", "pin_slam_ros", "vis_pin_map")
    for f in files:
        with open(f) as fh:
            for name in _import_names(ast.parse(fh.read())):
                top = name.split(".")[0]
                assert top not in banned, (f, name)
    code = ("import sys, importlib, pkgutil, pin_slam_torch\n"
            "for m in pkgutil.walk_packages(pin_slam_torch.__path__, 'pin_slam_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pin_slam_tpu', 'bench',\n"
            "                                                 'pin_slam_ros', 'vis_pin_map')]\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_entry_point_refuses_silent_cpu_fallback(monkeypatch):
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cfg)
    cfg2 = _config(Config, True)
    cfg2.layer_norm_on = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSystem(cfg2, device="cpu")


@pytest.mark.parametrize("option, value, error, label", [
    ("fresh_freespace_damp", 0.5, NotImplementedError, "ROADMAP"),
    ("probe_dedup_near_budget", 0.25, NotImplementedError, "ROADMAP"),
    ("layer_norm_on", True, NotImplementedError, "ROADMAP"),
    ("dp_devices", 2, RuntimeError, "torchrun --nproc-per-node 2")],
    ids=["fresh_freespace_damp-0.5", "probe_dedup_near_budget-0.25", "layer_norm_on-True",
         "dp_devices-2"])
def test_unported_option_raises(option, value, error, label):
    """Options outside the port (and knobs the JAX package measured and
    rejected) raise instead of being ignored; dp_devices > 1 without a
    process group of that size raises, naming the launch, instead of
    running on one device."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, True)
    setattr(cfg, option, value)
    with pytest.raises(error, match=label):
        SlamSystem(cfg, device="cpu")


def test_run_on_kitti_format_sequence(tmp_path):
    """SlamSystem.run over a KITTI-format sequence on disk (velodyne .bin +
    poses.txt): the dataset front, the pose books and the results file."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    root = tmp_path / "seq"
    (root / "velodyne").mkdir(parents=True)
    rng = np.random.default_rng(1)
    world = syn.make_world(np.random.default_rng(0))
    with open(root / "poses.txt", "w") as f:
        for i in range(3):
            R, t = syn.sensor_pose(i)
            pts = syn.lidar_scan(rng, world, t, R, N_RAYS)
            np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
                str(root / "velodyne" / f"{i:06d}.bin"))
            f.write(" ".join(f"{v:.9f}" for v in np.hstack([R, t[:, None]]).ravel()) + "\n")
    cfg = _config(Config, True)
    cfg.pc_path, cfg.pose_path = str(root / "velodyne"), str(root / "poses.txt")
    cfg.run_path = str(tmp_path / "run")
    system = SlamSystem(cfg, device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    infos = system.run()
    assert len(infos) == 3 and all(x["reg_valid"] for x in infos[1:]), infos
    est = np.loadtxt(tmp_path / "run" / "odom_poses_kitti.txt").reshape(-1, 3, 4)
    gt = system.dataset.gt_poses
    assert est.shape[0] == 3
    assert np.abs(est[:, :, 3] - gt[:, :3, 3]).max() < 0.15


def make_square_dataset(root, rng, side=8.0, step=0.8):
    """tests/test_full_slam.py's square-loop scene as KITTI-format frames on
    disk (the port's in-memory copy of it, written out)."""
    from pin_slam_torch.utils import synthetic as syn

    scans, poses = syn.make_square_scene(rng, side, step)
    os.makedirs(f"{root}/velodyne", exist_ok=True)
    for f, scan in enumerate(scans):
        scan.tofile(f"{root}/velodyne/{f:06d}.bin")
    with open(f"{root}/poses.txt", "w") as fp:
        for T in poses:
            fp.write(" ".join(f"{v:.9f}" for v in T[:3, :].reshape(-1)) + "\n")
    return len(scans)


@pytest.mark.slow
def test_square_loop_seed5_odometry(tmp_path):
    """The JAX package's seed-5 square-loop odometry gate
    (tests/test_full_slam.py), on the port: endpoint < 0.12 m, max < 0.15 m."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    root = str(tmp_path / "seq")
    n = make_square_dataset(root, np.random.default_rng(5))
    cfg = Config()
    cfg.pc_path, cfg.pose_path = f"{root}/velodyne", f"{root}/poses.txt"
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.bs, cfg.iters, cfg.reg_iter_n = 8192, 15, 100
    cfg.silence, cfg.pgo_on = True, False
    cfg.map_capacity, cfg.local_map_capacity = 1 << 18, 1 << 16
    cfg.buffer_size, cfg.frame_bucket, cfg.source_bucket = 1 << 21, 1 << 14, 1 << 12
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 19, 1 << 19
    cfg._derive()
    cfg.log_loss_per_frame = False
    system = SlamSystem(cfg, device="cuda" if torch.cuda.is_available() else "cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    invalid = 0
    for i in range(n):
        info = system.process_frame(system.dataset.preprocess_frame(i))
        invalid += info.get("reg_valid") is False
    est = np.stack(system.dataset.odom_poses)
    errs = np.linalg.norm(est[:, :3, 3] - system.dataset.gt_poses[: len(est), :3, 3], axis=1)
    assert invalid == 0, f"{invalid} invalid registrations"
    assert errs[-1] < 0.12, f"seed-5 endpoint {errs[-1]:.3f} m"
    assert errs.max() < 0.15, f"seed-5 max {errs.max():.3f} m"
