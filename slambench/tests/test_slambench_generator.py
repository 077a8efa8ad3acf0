"""The generator: sequences repeat exactly from a seed, the sweeps agree
with their ground truth and the scene, and a moving sweep's firing times are
the ones the port recovers from a point's azimuth."""

import math

import numpy as np
import pytest
import torch

from slambench.generators import lidar_scene as gen_mod
from slambench import harness

SMALL = {"blocks": [[2.0, -24.8, 8]], "columns": 180}


def _gen(cell, seed, sensor=SMALL):
    spec = harness.load_cell(cell)
    return gen_mod.make({**spec.config["sensor"], **sensor}, spec.traffic, seed, "cpu")


@pytest.mark.parametrize("cell", ["kitti_hdl64.drive", "kitti_hdl64.loop"])
def test_sequence_repeats_exactly_from_a_seed(cell):
    big = 2 ** 40 + 12345                     # seeds past 32 bits
    a = _gen(cell, big).sequence(4)
    b = _gen(cell, big).sequence(4)
    c = _gen(cell, big + 1).sequence(4)
    assert np.array_equal(a.gt_poses, b.gt_poses)
    assert all(np.array_equal(x, y) for x, y in zip(a.scans, b.scans))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a.scans, c.scans))
    # the mix names its scene and its motion: every seed has the same, and
    # draws only the sensor's noise
    assert torch.equal(a.scene.lo, c.scene.lo) and np.array_equal(a.gt_poses, c.gt_poses)


@pytest.mark.parametrize("cell,sensor", [
    ("kitti_hdl64.drive", SMALL), ("kitti_hdl64.loop", SMALL),
    # a rolling sweep: each column fired at its own time along the motion
    ("kitti_hdl64.drive", {**SMALL, "moving_sweep": True})])
def test_sweeps_lie_on_the_scene_through_their_ground_truth(cell, sensor):
    g = _gen(cell, 7, sensor)
    seq = g.sequence(6)
    noise = float(g.sensor["range_noise_m"])
    for i in (0, 5):
        T = torch.as_tensor(seq.gt_poses[i])
        w = torch.as_tensor(seq.scans[i], dtype=torch.float64) @ T[:3, :3].T + T[:3, 3]
        sdf = gen_mod.scene_sdf(g.scene, w).abs()
        # a moving sweep's points were taken at poses up to half a frame away
        tol = 5 * noise if not g.sensor["moving_sweep"] else 0.25
        assert float(torch.quantile(sdf, 0.5)) < tol
        _, world, _ = g.hits(i, noise=False)
        # cast in float32 about the sweep's origin: exact to 0.1 mm
        assert float(gen_mod.scene_sdf(g.scene, world).abs().max()) < 1e-4


def test_moving_sweep_times_are_the_azimuths_the_port_recovers():
    from pin_slam_torch.dataset.slam_dataset import recover_point_ts

    g = _gen("kitti_hdl64.drive", 3, {"blocks": [[45.0, -45.0, 16]], "columns": 256,
                                       "moving_sweep": True})
    pts, _, _ = g.hits(2, noise=False)
    ts = recover_point_ts(pts.numpy().astype(np.float64))
    C = int(g.sensor["columns"])
    col = np.round(ts * C - 0.5)
    assert np.allclose(ts, (col + 0.5) / C, atol=1e-6)


def test_closed_path_returns_to_its_start_after_a_lap():
    g = _gen("kitti_hdl64.loop", 1)
    L = g.path.length
    xy0, t0 = gen_mod.path_at(g.path, torch.tensor([0.0], dtype=torch.float64))
    xy1, t1 = gen_mod.path_at(g.path, torch.tensor([L], dtype=torch.float64))
    assert torch.allclose(xy0, xy1, atol=1e-9) and torch.allclose(t0, t1, atol=1e-6)
    # the circuit round a 130 x 70 m block, its corners rounded, is longer
    # than the travel a loop candidate needs (min_loop_travel_ratio x
    # local_map_radius = 4 x 82 m)
    assert 4.0 * 82.0 < L < 2 * (130.0 + 70.0)


def test_speed_ramps_from_standstill():
    g = _gen("kitti_hdl64.drive", 1)
    v = g.traj.speed(torch.tensor([0.0, 15.0, 30.0, 100.0], dtype=torch.float64))
    assert float(v[0]) == 0.0 and 0 < float(v[1]) < float(v[2])
    assert abs(float(v[3]) - 0.8) <= 0.8 * 0.15 + 1e-9
    # the arc length is the speed's integral
    s = g.traj.arc(torch.tensor([40.0, 41.0], dtype=torch.float64))
    assert math.isclose(float(s[1] - s[0]), float(g.traj.speed(torch.tensor([40.5],
                        dtype=torch.float64))), rel_tol=1e-3)


@pytest.mark.parametrize("cell,sensor", [
    ("kitti_hdl64.drive", {"columns": 120}), ("kitti_hdl64.loop", {"columns": 120}),
    # a 90 deg field of view, half of it looking up past the buildings
    ("kitti_hdl64.drive", {"blocks": [[45.0, -45.0, 32]], "columns": 120})])
def test_column_culled_cast_equals_every_ray_against_every_box(cell, sensor):
    g = _gen(cell, 5, sensor)
    for i in (0, 33):
        o_col, d_col = g._frame_rays(i)
        rmax = float(g.sensor["max_range_m"])
        lo, hi = g._boxes_near(o_col[0], rmax + 1.0)
        fast = gen_mod.cast_columns(lo, hi, o_col, d_col, rmax)
        C, B = d_col.shape[:2]
        o = o_col[:, None, :].expand(C, B, 3).reshape(-1, 3)
        slow = gen_mod.cast(lo, hi, o, d_col.reshape(-1, 3), rmax)
        assert torch.equal(torch.isfinite(fast), torch.isfinite(slow))
        both = torch.isfinite(slow)
        assert float((fast[both] - slow[both]).abs().max()) < 1e-3      # float32 about the origin
        assert int(both.sum()) > 0.5 * both.numel()


@pytest.mark.parametrize("cell", ["kitti_hdl64.drive", "kitti_hdl64.loop"])
def test_the_carrier_keeps_clear_of_every_box(cell):
    g = _gen(cell, 9)
    R, t = g.traj.poses(torch.arange(0.0, 2000.0, 0.5, dtype=torch.float64))
    assert float(gen_mod.scene_sdf(g.scene, t).min()) > 0.5
