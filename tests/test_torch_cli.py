"""The port's batch command-line driver (``python -m pin_slam_torch.cli``)
against the JAX package's (``pin_slam_tpu/cli.py``) on a tiny KITTI-layout
sequence, and every shipped profile in its dataset's layout: each builds a
SlamSystem and reads its frames (deskewed where the profile asks), or
refuses with the ROADMAP item that would port it."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from pin_slam_torch.utils import synthetic as syn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1 << 13
SMALL = {"map_capacity": 1 << 15, "local_map_capacity": 1 << 13, "frame_bucket": N_RAYS,
         "source_bucket": 1 << 11}


def _corridor(n):
    rng = np.random.default_rng(0)
    world = syn.make_world(np.random.default_rng(0))
    scans, poses = [], []
    for i in range(n):
        R, t = syn.sensor_pose(i)
        pts = syn.lidar_scan(rng, world, t, R, N_RAYS)
        scans.append(np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)],
                                    1))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T)
    return scans, np.stack(poses)


def _small_profile(path, src, root, out, **over):
    with open(os.path.join(ROOT, src)) as f:
        prof = yaml.safe_load(f)
    prof["setting"].update(pc_path=root, output_root=out)
    prof["eval"] = {**prof.get("eval", {}), "silence_log": True}
    prof["continual"] = {**prof.get("continual", {}), "pool_capacity": 1 << 17}
    prof["optimizer"] = {**prof.get("optimizer", {}), "iters": 3, "batch_size": 2048}
    prof["tpu"] = {**prof.get("tpu", {}), **SMALL, **over}
    with open(path, "w") as f:
        yaml.safe_dump(prof, f)
    return path


def _files(run):
    return sorted(os.path.relpath(p, run) for p in glob.glob(os.path.join(run, "**"),
                                                              recursive=True)
                  if os.path.isfile(p))


def test_cli_writes_the_jax_cli_file_set(tmp_path, monkeypatch):
    from pin_slam_torch import cli as tcli
    from pin_slam_tpu import cli as jcli
    from pin_slam_tpu.utils import platform as jplat

    scans, poses = _corridor(3)
    data = str(tmp_path / "kitti")
    syn.write_kitti_sequence(data, "00", scans, poses)
    runs = {}
    for name, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"out_{name}")
        prof = _small_profile(str(tmp_path / f"{name}.yaml"), "config/lidar_slam/run_kitti.yaml",
                              data, out)
        monkeypatch.setattr(jplat, "enable_compilation_cache", lambda *a, **k: None)
        assert main([prof, "kitti", "00", "--frames", "3"] + extra) == 0
        (run,) = glob.glob(os.path.join(out, "*"))
        runs[name] = run
    ft, fj = _files(runs["torch"]), _files(runs["jax"])
    assert ft == fj and "viewer.html" in ft, (ft, fj)
    for f in ("summary.json", "meta/run.json", "pose_eval.csv", "map/pin_map.npz"):
        assert f in ft
    st, sj = (json.load(open(os.path.join(runs[k], "summary.json"))) for k in ("torch", "jax"))
    assert st.keys() == sj.keys() and st["frames"] == 3
    assert json.load(open(os.path.join(runs["torch"], "meta", "run.json")))["seed"] == \
        json.load(open(os.path.join(runs["jax"], "meta", "run.json")))["seed"]
    assert os.path.basename(runs["torch"]).startswith("test_kitti_kitti_00_")
    # the ground truth came through calib.txt into the LiDAR frame
    est = np.loadtxt(os.path.join(runs["torch"], "odom_poses_kitti.txt")).reshape(-1, 3, 4)
    assert np.abs(est[0] - poses[0][:3]).max() < 1e-6


def test_cli_runs_on_the_gpu_unless_cpu_is_named(tmp_path, monkeypatch):
    from pin_slam_torch import cli

    scans, poses = _corridor(1)
    data = str(tmp_path / "kitti")
    syn.write_kitti_sequence(data, "00", scans, poses)
    prof = _small_profile(str(tmp_path / "p.yaml"), "config/lidar_slam/run_kitti.yaml", data,
                          str(tmp_path / "out"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([prof, "kitti", "00"])


def _write_layout(kind, root, seq, scans, poses):
    """A one-sequence dataset under ``root`` in the layout
    ``dataset/indexing.py`` expects; returns the frames' directory."""
    if kind == "kitti":
        return syn.write_kitti_sequence(root, seq, scans, poses)
    ts = [syn.sweep_time(s[:, :3]) for s in scans]
    if kind == "ncd128":
        return syn.write_ncd_sequence(root, seq, scans, ts, poses)
    if kind == "replica":
        # the converters' layout: rgbd_ply/*.ply with RGB, poses.txt
        from pin_slam_torch.dataset import io as pio

        d = os.path.join(root, seq, "rgbd_ply")
        os.makedirs(d, exist_ok=True)
        for i, s in enumerate(scans):
            pio.write_ply(os.path.join(d, f"{i:06d}.ply"), s[:, :3],
                          colors=np.repeat(s[:, 3:4], 3, axis=1))
        pio.write_kitti_poses(os.path.join(root, seq, "poses.txt"), poses)
        return d
    d = os.path.join(root, seq, {"mulran": "Ouster", "ipbcar": "ouster"}.get(kind, ""))
    os.makedirs(d, exist_ok=True)
    for i, s in enumerate(scans):
        if kind == "ipbcar":
            from pin_slam_torch.dataset import io as pio

            pio.write_ply(os.path.join(d, f"{i:06d}.ply"), s[:, :3],
                          extra={"intensity": s[:, 3], "t": ts[i].astype(np.float32)})
        else:
            s.astype(np.float32).tofile(os.path.join(d, f"{i:06d}.bin"))
    syn.write_poses(os.path.join(root, seq, "poses.txt"), poses)
    return d


# (profile, dataset name for set_dataset_path or None, layout, refusal or None)
PROFILES = [
    ("lidar_slam/run_kitti.yaml", "kitti", "kitti", None),
    ("lidar_slam/run_mulran.yaml", "mulran", "mulran", None),
    ("lidar_slam/run_ncd_128.yaml", "ncd128", "ncd128", None),
    ("lidar_slam/run_ipbcar.yaml", "ipbcar", "ipbcar", None),
    ("lidar_slam/run_apollo.yaml", None, "kitti", None),
    ("lidar_slam/run_demo.yaml", None, "kitti", None),
    ("lidar_slam/run_demo_cpu.yaml", None, "kitti", None),
    ("lidar_slam/run_demo_no_vis.yaml", None, "kitti", None),
    ("lidar_slam/run_ros_general.yaml", None, None, None),
    ("lidar_slam/run_livox.yaml", None, None, None),
    ("rgbd_slam/run_replica.yaml", "replica", "replica", None),
]


def test_every_shipped_profile_is_listed():
    shipped = sorted(os.path.relpath(p, os.path.join(ROOT, "config"))
                     for p in glob.glob(os.path.join(ROOT, "config", "*", "*.yaml")))
    assert shipped == sorted(p for p, _, _, _ in PROFILES)


@pytest.mark.parametrize("profile, name, layout, refusal", PROFILES,
                         ids=[os.path.basename(p[0]) for p in PROFILES])
def test_shipped_profile_builds_and_reads_frames(tmp_path, profile, name, layout, refusal):
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.indexing import set_dataset_path
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = Config().load(os.path.join(ROOT, "config", profile))
    scans, poses = _corridor(2)
    root = str(tmp_path / "data")
    if layout is not None:
        frames_dir = _write_layout(layout, root, "00", scans, poses)
        cfg.pc_path = root if name else frames_dir
        if not name:
            cfg.pose_path = ""
    else:
        cfg.pc_path = cfg.pose_path = ""
    if name:
        set_dataset_path(cfg, name, "00")
    cfg.map_capacity, cfg.local_map_capacity = 1 << 12, 1 << 10
    cfg.buffer_size, cfg.pool_capacity, cfg.downsample_hash_size = 1 << 14, 1 << 12, 1 << 12
    cfg.frame_bucket = 1 << 12
    cfg._derive()
    if refusal:
        with pytest.raises(NotImplementedError, match=refusal):
            SlamSystem(cfg, device="cpu")
        return
    system = SlamSystem(cfg, device="cpu")
    if layout is None:
        return
    ds = system.dataset
    assert len(ds) == 2
    f0 = ds.preprocess_frame(0)
    assert f0.raw_count > 1000 and np.isfinite(f0.points).all()
    if cfg.color_on:
        assert f0.colors is not None and f0.colors.shape == (f0.points.shape[0], 3)
        assert system.color_decoder is not None and system.pool.color_label is not None
    if name == "kitti":
        assert cfg.kitti_correction_on and cfg.correction_deg == pytest.approx(0.195)
        assert np.abs(ds.gt_poses - poses).max() < 1e-9
    if cfg.deskew:
        assert f0.point_ts is not None
        ds.processed_frame, ds.last_odom_tran = 1, np.linalg.inv(poses[0]) @ poses[1]
        f1 = ds.preprocess_frame(1)
        assert np.isfinite(f1.points).all() and f1.raw_count > 1000
