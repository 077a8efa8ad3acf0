"""The port's frame preprocessing against the JAX package's on the same
KITTI-format scans: the range crop (fixed, or adaptive to the scan's
horizontal extent), the z crop, the random downsampling and the bucket cap
must keep exactly the same points in the same order."""

import numpy as np
import pytest

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.dataset.slam_dataset import SLAMDataset as TDataset
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.dataset.slam_dataset import SLAMDataset as JDataset


def _scans(root, rng):
    """Three scans of a corridor, narrow but for one long arm, so the adaptive
    crop (twice the larger of the two axes' smaller half-extents) binds well
    inside max_range."""
    root.mkdir()
    for f in range(3):
        n = 6000
        pts = np.stack([rng.uniform(-4.0 - f, 3.0 + f, n), rng.uniform(-28.0, 4.0 + f, n),
                        rng.uniform(-3, 6, n), rng.uniform(0, 1, n)], 1).astype(np.float32)
        pts.tofile(str(root / f"{f:06d}.bin"))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_preprocess_frame_matches_jax(tmp_path, adaptive):
    _scans(tmp_path / "velodyne", np.random.default_rng(5))
    frames = []
    for Config, Dataset in ((JConfig, JDataset), (TConfig, TDataset)):
        cfg = Config()
        cfg.pc_path = str(tmp_path / "velodyne")
        cfg.adaptive_range_on = adaptive
        cfg.min_range, cfg.max_range = 1.5, 30.0
        cfg.min_z, cfg.max_z = -2.0, 5.0
        cfg.rand_downsample, cfg.rand_down_r = True, 0.8
        cfg.frame_bucket = 1 << 12
        frames.append([Dataset(cfg).preprocess_frame(i) for i in range(3)])
    for i, (fj, ft) in enumerate(zip(*frames)):
        assert ft.raw_count == fj.raw_count > 0
        np.testing.assert_array_equal(ft.valid, fj.valid)
        np.testing.assert_array_equal(ft.points, fj.points)
        kept = np.linalg.norm(ft.points[ft.valid], axis=1)
        # scan i spans x in [-4 - i, 3 + i), y in [-28, 4 + i): the adaptive
        # crop is 2 (4 + i) m, and the fixed one keeps points beyond it
        assert (kept.max() < 2 * (4 + i) + 1e-3) == adaptive


def _points(rng, n, r_max=80.0):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * rng.uniform(1.0, r_max, (n, 1))).astype(np.float32)


def test_intrinsic_correct_and_recover_point_ts_exact():
    from pin_slam_torch.dataset import slam_dataset as td
    from pin_slam_tpu.dataset import slam_dataset as jd

    pts = _points(np.random.default_rng(1), 5000)
    for deg in (0.0, 0.195, -1.0):
        a, b = td.intrinsic_correct(pts, deg), jd.intrinsic_correct(pts, deg)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a, b = td.recover_point_ts(pts), jd.recover_point_ts(pts)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _rel_pose(rng, angle):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) / np.sqrt(3) * angle).as_matrix()
    T[:3, 3] = rng.normal(size=3) * 0.5
    return T


@pytest.mark.parametrize("angle", [0.0, 1e-7, 0.05, 0.3])
def test_quat_slerp_matches_jax(angle):
    import jax
    import jax.numpy as jnp
    import torch

    from pin_slam_torch.ops import transforms as tt
    from pin_slam_tpu.ops import transforms as jt

    rng = np.random.default_rng(2)
    R = _rel_pose(rng, angle)[:3, :3].astype(np.float32)
    q1j = jt.rotmat_to_quat(jnp.asarray(R))
    q1t = tt.rotmat_to_quat(torch.as_tensor(R))
    np.testing.assert_allclose(q1t.numpy(), np.asarray(q1j), atol=1e-6)
    q0 = np.array([1.0, 0, 0, 0], np.float32)
    u = rng.uniform(-0.5, 1.0, (300, 1)).astype(np.float32)
    a = tt.quat_slerp(torch.as_tensor(q0)[None], q1t[None], torch.as_tensor(u))
    b = jax.jit(jt.quat_slerp)(jnp.asarray(q0)[None], q1j[None], jnp.asarray(u))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-7)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("angle", [0.0, 0.02, 0.1])
def test_deskew_points_matches_jax(angle, masked):
    """Within 3e-5 m at ranges up to 80 m, with and without the valid mask
    (padding rows with times outside the sweep must not widen it; their
    outputs are compared nowhere, as nothing reads them)."""
    import jax
    import jax.numpy as jnp
    import torch

    from pin_slam_torch.ops import transforms as tt
    from pin_slam_tpu.ops import transforms as jt

    rng = np.random.default_rng(3)
    n = 20000
    pts = _points(rng, n)
    ts = rng.uniform(10.0, 10.1, n).astype(np.float32)
    rel = _rel_pose(rng, angle).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones(n, bool)
        valid[-500:] = False
        ts[-500:] = 0.0
    fj = jax.jit(lambda p, t, r, v: jt.deskew_points(p, t, r, v))
    b = np.asarray(fj(jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(rel),
                      None if valid is None else jnp.asarray(valid)))
    a = tt.deskew_points(torch.as_tensor(pts), torch.as_tensor(ts), torch.as_tensor(rel),
                         None if valid is None else torch.as_tensor(valid)).numpy()
    keep = np.ones(n, bool) if valid is None else valid
    # the padding rows (time 0, far outside the sweep) are not points
    assert np.linalg.norm(a - b, axis=1)[keep].max() < 3e-5
    # deskewing moves points (by up to the sweep's motion), not by noise
    if angle > 0:
        assert np.linalg.norm(a - pts, axis=1).max() > 0.1


@pytest.mark.parametrize("with_ts", [True, False], ids=["file_ts", "recovered_ts"])
def test_preprocess_frame_deskew_and_correction_match_jax(tmp_path, with_ts, monkeypatch):
    """preprocess_frame with KITTI's correction and deskew on, after a first
    frame has set the relative motion: the same points kept (masks exact),
    deskewed within 3e-5 m; timestamps from the PLY's ``time`` property or
    recovered from the scan yaw."""
    import torch

    from pin_slam_torch.dataset import io as tio

    rng = np.random.default_rng(4)
    root = tmp_path / "ply"
    root.mkdir()
    for f in range(2):
        pts = _points(rng, 6000, 60.0)
        extra = {"intensity": rng.uniform(0, 1, 6000).astype(np.float32)}
        if with_ts:
            extra["time"] = rng.uniform(0, 0.1, 6000).astype(np.float32)
        tio.write_ply(str(root / f"{f:06d}.ply"), pts, extra=extra)
    rel = _rel_pose(rng, 0.08)
    frames = []
    for Config, Dataset, kw in ((JConfig, JDataset, {}), (TConfig, TDataset, {"device": "cpu"})):
        cfg = Config()
        cfg.pc_path = str(root)
        cfg.deskew = True
        cfg.kitti_correction_on, cfg.correction_deg = True, 0.195
        cfg.min_range, cfg.max_range = 1.5, 50.0
        cfg.rand_downsample, cfg.rand_down_r = True, 0.8
        cfg.frame_bucket = 1 << 12
        ds = Dataset(cfg, **kw)
        ds.processed_frame = 1
        ds.last_odom_tran = rel.copy()
        frames.append([ds.preprocess_frame(i) for i in range(2)])
    for fj, ft in zip(*frames):
        assert ft.raw_count == fj.raw_count > 0
        np.testing.assert_array_equal(ft.valid, fj.valid)
        np.testing.assert_array_equal(ft.point_ts, fj.point_ts)
        assert np.linalg.norm(ft.points - fj.points, axis=1).max() < 3e-5
    # built alone, a deskewing dataset runs on the GPU: none here, so it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDataset(cfg)


def test_dataset_moves_gt_poses_through_calibration(tmp_path):
    """Ground truth in KITTI's camera frame plus calib.txt: the dataset holds
    the LiDAR poses, as the JAX package's does."""
    from pin_slam_torch.utils import synthetic as syn

    rng = np.random.default_rng(5)
    poses = np.stack([syn.pose_matrix(rng.normal(size=3) * 5, rng.uniform(-3, 3))
                      for _ in range(4)])
    velo = syn.write_kitti_sequence(str(tmp_path), "03", [_points(rng, 100)] * 4, poses)
    gts = []
    for Config, Dataset in ((JConfig, JDataset), (TConfig, TDataset)):
        cfg = Config()
        cfg.pc_path = velo
        cfg.pose_path = str(tmp_path / "poses" / "03.txt")
        cfg.calib_path = str(tmp_path / "sequences" / "03" / "calib.txt")
        gts.append(Dataset(cfg).gt_poses)
    np.testing.assert_array_equal(gts[1], gts[0])
    assert np.abs(gts[1] - poses).max() < 1e-9
