"""The port's dataset IO (pin_slam_torch.dataset.io and .indexing) against
the JAX package's: every reader on files written by the JAX writers (or, for
PCD, which has no writer, by hand) returns the same arrays exactly; the PLY
and LAS writers write the same bytes; KITTI calibration and the GT pose
transform are exact; dataset names map to the same paths and switches."""

import os

import numpy as np
import pytest

from pin_slam_torch.dataset import io as tio
from pin_slam_tpu.dataset import io as jio


def _cloud(rng, n=500):
    pts = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    return pts, rng.uniform(0, 1, n).astype(np.float32), np.sort(rng.uniform(0, 0.1, n))


def _same(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", ["timestamp", "time", "t", None])
def test_ply_reader_with_timestamps(tmp_path, key):
    pts, inten, ts = _cloud(np.random.default_rng(1))
    extra = {"intensity": inten}
    if key:
        extra[key] = ts.astype(np.float32)
    path = str(tmp_path / "a.ply")
    jio.write_ply(path, pts, extra=extra)
    for a, b in zip(tio.read_point_cloud(path), jio.read_point_cloud(path)):
        _same(a, b)
    got = tio.read_point_cloud(path)
    np.testing.assert_array_equal(got[0], pts)
    if key:
        np.testing.assert_array_equal(got[2], ts.astype(np.float32).astype(np.float64))


def test_ply_reader_colours_and_faces(tmp_path):
    rng = np.random.default_rng(2)
    pts, _, _ = _cloud(rng, 60)
    col = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (30, 3))
    path = str(tmp_path / "m.ply")
    jio.write_ply(path, pts, colors=col, normals=pts / 40.0, faces=faces)
    for a, b in zip(tio.read_point_cloud(path), jio.read_point_cloud(path)):
        _same(a, b)
    dt, dj = tio.read_ply(path), jio.read_ply(path)
    assert dt.keys() == dj.keys()
    for k in dt:
        _same(dt[k], dj[k])


def _write_pcd(path, pts, inten, ts, binary):
    fields = "x y z intensity t"
    head = ["# .PCD v0.7", "VERSION 0.7", f"FIELDS {fields}", "SIZE 4 4 4 4 8",
            "TYPE F F F F F", "COUNT 1 1 1 1 1", f"WIDTH {len(pts)}", "HEIGHT 1",
            "VIEWPOINT 0 0 0 1 0 0 0", f"POINTS {len(pts)}",
            f"DATA {'binary' if binary else 'ascii'}"]
    rec = np.empty(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                    ("intensity", "<f4"), ("t", "<f8")])
    rec["x"], rec["y"], rec["z"] = pts.T
    rec["intensity"], rec["t"] = inten, ts
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for r in rec:
                f.write((" ".join(repr(float(v)) for v in r) + "\n").encode())


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_reader(tmp_path, binary):
    pts, inten, ts = _cloud(np.random.default_rng(3), 200)
    path = str(tmp_path / "a.pcd")
    _write_pcd(path, pts, inten, ts, binary)
    for a, b in zip(tio.read_point_cloud(path), jio.read_point_cloud(path)):
        _same(a, b)
    got = tio.read_point_cloud(path)
    np.testing.assert_array_equal(got[0], pts)
    np.testing.assert_array_equal(got[2], ts)
    dt, dj = tio.read_pcd(path), jio.read_pcd(path)
    for k in dj:
        _same(dt[k], dj[k])


@pytest.mark.parametrize("colors, gps", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_las_writer_bytes_and_reader(tmp_path, colors, gps):
    rng = np.random.default_rng(4)
    pts, inten, ts = _cloud(rng, 300)
    col = rng.uniform(0, 1, (300, 3)) if colors else None
    kw = dict(intensity=inten * 1000, colors=col, gps_time=ts if gps else None)
    pj, pt = str(tmp_path / "j.las"), str(tmp_path / "t.las")
    jio.write_las(pj, pts, **kw)
    tio.write_las(pt, pts, **kw)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    dt, dj = tio.read_las(pj), jio.read_las(pj)
    assert dt.keys() == dj.keys()
    for k in dj:
        _same(dt[k], dj[k])
    for a, b in zip(tio.read_point_cloud(pj), jio.read_point_cloud(pj)):
        _same(a, b)
    got = tio.read_point_cloud(pj)
    assert np.abs(got[0] - pts).max() < 1e-4
    if gps:
        np.testing.assert_array_equal(got[2], ts)
    else:
        assert got[2] is None


def test_ply_writer_bytes(tmp_path):
    rng = np.random.default_rng(5)
    pts, inten, ts = _cloud(rng, 100)
    kw = dict(colors=rng.uniform(0, 1, (100, 3)), normals=pts / 40.0,
              faces=rng.integers(0, 100, (40, 3)), extra={"intensity": inten, "time": ts})
    jio.write_ply(str(tmp_path / "j.ply"), pts, **kw)
    tio.write_ply(str(tmp_path / "t.ply"), pts, **kw)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def test_unknown_extension_raises_value_error(tmp_path):
    path = str(tmp_path / "a.xyz")
    open(path, "w").close()
    with pytest.raises(ValueError):
        jio.read_point_cloud(path)
    with pytest.raises(ValueError, match="unsupported point cloud format"):
        tio.read_point_cloud(path)


def _poses(rng, n=7):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.normal(size=(n, 3))).as_matrix()
    T[:, :3, 3] = rng.normal(size=(n, 3)) * 10
    return T


def test_pose_readers(tmp_path):
    rng = np.random.default_rng(6)
    T = _poses(rng)
    kitti, tum = str(tmp_path / "k.txt"), str(tmp_path / "t.txt")
    jio.write_kitti_poses(kitti, T)
    ts = np.arange(len(T)) * 0.1 + 1e9
    jio.write_tum_poses(tum, T, ts)
    _same(tio.read_kitti_poses(kitti), jio.read_kitti_poses(kitti))
    for a, b in zip(tio.read_tum_poses(tum), jio.read_tum_poses(tum)):
        _same(a, b)
    with pytest.raises(ValueError):
        tio.read_kitti_poses(tum)


def test_kitti_calibration_exact(tmp_path):
    from pin_slam_torch.utils import synthetic as syn

    rng = np.random.default_rng(7)
    T = _poses(rng)
    root = str(tmp_path / "kitti")
    syn.write_kitti_sequence(root, "00", [np.zeros((4, 4), np.float32)] * len(T), T)
    calib = os.path.join(root, "sequences", "00", "calib.txt")
    ct, cj = tio.read_kitti_calib(calib), jio.read_kitti_calib(calib)
    assert ct.keys() == cj.keys() and "Tr" in ct
    for k in cj:
        _same(ct[k], cj[k])
    np.testing.assert_array_equal(ct["Tr"], syn.KITTI_TR)
    cam = tio.read_kitti_poses(os.path.join(root, "poses", "00.txt"))
    lidar = tio.apply_kitti_calib(cam, ct["Tr"])
    _same(lidar, jio.apply_kitti_calib(cam, cj["Tr"]))
    # the camera-frame file, moved back through Tr, is the scene's LiDAR poses
    assert np.abs(lidar - T).max() < 1e-9


DATASETS = ["kitti", "kitti_carla", "mulran", "ncd", "ncd128", "ipbcar", "ntu", "hilti",
            "eth_dynamic", "m2dgr", "replica", "neuralrgbd", "tum", "scannet", ""]
FIELDS = ["name", "pc_path", "pose_path", "calib_path", "label_path", "kitti_correction_on",
          "correction_deg", "color_map_on", "color_on", "color_channel"]


@pytest.mark.parametrize("semantic", [False, True])
@pytest.mark.parametrize("name", DATASETS)
def test_set_dataset_path_matches_jax(name, semantic):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.indexing import set_dataset_path as tset
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.indexing import set_dataset_path as jset

    cfgs = []
    for Config, fn in ((JConfig, jset), (TConfig, tset)):
        cfg = Config()
        cfg.pc_path, cfg.name, cfg.semantic_on = "/data/root", "run", semantic
        fn(cfg, name, "05")
        cfgs.append(cfg)
    for f in FIELDS:
        assert getattr(cfgs[0], f) == getattr(cfgs[1], f), f


def test_set_dataset_path_unknown_name():
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.indexing import set_dataset_path

    with pytest.raises(ValueError, match="unknown dataset name"):
        set_dataset_path(Config(), "nuscenes", "00")
