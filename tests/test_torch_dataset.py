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
