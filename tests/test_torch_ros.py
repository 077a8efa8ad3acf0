"""The port's streaming core and ROS node (``pin_slam_torch.ros``) against
the repository's ``pin_slam_ros.py`` on the CPU.

``StreamingSlam``: tests/test_streaming.py's setup, 3 frames pushed into both
packages with the port's random draws replaced by the JAX package's and its
state synced from the JAX system before each frame (free-running runs part
by centimetres, ROADMAP C 7): the same cropped and capped mapping cloud
(exact), poses within 2 cm / 0.2 deg, the same decimated neural-point cloud
from the same map (exact), and ``finish()``'s file set.

``PinSlamRosNode``: under tests/test_ros_node.py's fakes of ``rospy``, the
message modules and ``tf2_ros``, it publishes and serves as the JAX node
does, rebuilds the path from the pose graph after a PGO, and ``spin()``
finishes the run on the silence timeout; ``main()`` returns 3 without
``rospy``."""

import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_ros_node import _Header, _ns, fake_ros  # noqa: F401  (fake_ros is a fixture)

torch.set_num_threads(1)


def _config(Config, out, **over):
    """tests/test_streaming.py's configuration."""
    cfg = Config()
    cfg.min_range, cfg.max_range = 0.5, 20.0
    cfg.bs, cfg.iters = 2048, 8
    cfg.reg_iter_n = 30
    cfg.silence = True
    cfg.map_capacity, cfg.local_map_capacity = 1 << 16, 1 << 15
    cfg.buffer_size = 1 << 20
    cfg.frame_bucket, cfg.source_bucket = 1 << 13, 1 << 11
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 17, 1 << 17
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg._derive()
    cfg.output_root = out
    return cfg


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_streaming_slam_matches_jax(tmp_path):
    from pin_slam_ros import StreamingSlam as JStream
    from test_mapping import ray_box_endpoints
    from test_torch_pipeline import JaxDraws, _sync_from_jax

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.ros import StreamingSlam as TStream
    from pin_slam_tpu.config import Config as JConfig

    # a frame above the bucket: both packages draw the same subsample
    js = JStream(_config(JConfig, str(tmp_path / "j"), frame_bucket=1 << 12))
    tcfg = _config(TConfig, str(tmp_path / "t"), frame_bucket=1 << 12)
    ts = TStream(tcfg, device="cpu")
    ts.system.rand = JaxDraws(tcfg.seed, js.system.mcfg)
    rng = np.random.default_rng(0)
    for f in range(3):
        pts = ray_box_endpoints(rng, 6000) + np.float32([0.02 * f, 0, 0])
        _sync_from_jax(ts.system, js.system)
        pj, pt = js.push_frame(pts), ts.push_frame(pts)
        np.testing.assert_array_equal(ts.last_mapping_cloud, js.last_mapping_cloud)
        assert ts.last_mapping_cloud.shape[0] == 1 << 12
        assert pt.shape == (4, 4) and np.isfinite(pt).all()
        assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < 0.02, (f, pt[:3, 3], pj[:3, 3])
        cos = (np.trace(pj[:3, :3].T @ pt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, f
    _sync_from_jax(ts.system, js.system)
    for rate in (3, None):
        a, b = ts.neural_point_cloud(rate), js.neural_point_cloud(rate)
        assert a.shape[0] > 50
        np.testing.assert_array_equal(a, b)
    assert ts.neural_point_cloud().shape[0] == math.ceil(int(ts.system.state.count) / 11)
    out_t, out_j = str(tmp_path / "t_out"), str(tmp_path / "j_out")
    ts.finish(out_t)
    js.finish(out_j)
    assert _files(out_t) == _files(out_j)
    assert {"odom_poses_kitti.txt", "map/neural_points.ply", "map/pin_map.npz",
            "viewer.html"} <= set(_files(out_t))


def _node_config(Config, out):
    cfg = Config()
    cfg.min_range, cfg.max_range = 0.5, 20.0
    cfg.bs, cfg.iters = 2048, 5
    cfg.init_iter_ratio = 2
    cfg.reg_iter_n = 30
    cfg.silence = True
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 14
    cfg.buffer_size = 1 << 18
    cfg.frame_bucket, cfg.source_bucket = 1 << 12, 1 << 10
    cfg.downsample_hash_size, cfg.pool_capacity = 1 << 16, 1 << 16
    cfg.mc_res_m = 0.3
    cfg._derive()
    cfg.output_root = out
    return cfg


def test_ros_node_publishes_and_serves(tmp_path, fake_ros):  # noqa: F811
    """tests/test_ros_node.py's checks on the port's node, plus the mesh
    service, the path rebuilt after a PGO and the silence watchdog."""
    from test_mapping import ray_box_endpoints

    from pin_slam_torch.config import Config
    from pin_slam_torch.ros import PinSlamRosNode

    cfg = _node_config(Config, str(tmp_path))
    node = PinSlamRosNode(cfg, cloud_topic="/points", init_node=False, device="cpu")
    assert {"~save_results", "~save_mesh"} <= set(fake_ros.services)
    assert "/points" in fake_ros.subscribers
    cb = fake_ros.subscribers["/points"]
    rng = np.random.default_rng(1)
    for f in range(2):
        pts = ray_box_endpoints(rng, 4096) + np.float32([0.02 * f, 0, 0])
        cb(_ns(pts=[tuple(p) for p in pts], header=_Header()))
    cb(_ns(pts=[], header=_Header()))                 # an empty cloud is skipped

    assert len(node.tf_broadcaster.sent) == 2
    tfm = node.tf_broadcaster.sent[-1]
    assert tfm.header.frame_id == "map" and tfm.child_frame_id == "range_sensor"
    odom = fake_ros.pubs["~odometry"].msgs
    assert len(odom) == 2 and odom[-1].child_frame_id == "range_sensor"
    o = odom[-1].pose.pose.orientation
    assert abs(np.linalg.norm([o.x, o.y, o.z, o.w]) - 1.0) < 1e-4
    pose = node.slam.system.cur_pose
    assert np.allclose([odom[-1].pose.pose.position.x, odom[-1].pose.pose.position.y,
                        odom[-1].pose.pose.position.z], pose[:3, 3])
    assert len(fake_ros.pubs["~pin_path"].msgs[-1].poses) == 2
    np_map = fake_ros.pubs["~map/neural_points"].msgs
    count = int(node.slam.system.state.count)
    assert len(np_map) == 2 and np_map[-1].pts.shape[0] == math.ceil(count / 11) > 10
    assert len(fake_ros.pubs["~frame/mapping"].msgs) == 2
    reg = fake_ros.pubs["~frame/registration"].msgs
    assert len(reg) == 1 and reg[-1].pts.shape[0] > 10   # tracking starts at frame 1

    fake_ros.services["~save_results"](None)
    assert os.path.exists(os.path.join(cfg.output_root, "odom_poses_kitti.txt"))
    fake_ros.services["~save_mesh"](None)
    assert os.path.getsize(os.path.join(cfg.output_root, "mesh", "mesh.ply")) > 0
    assert cfg.save_mesh is False

    # a PGO correction: the path is rebuilt from the pose graph's poses
    ds = node.slam.dataset
    ds.pgo_poses = [p.copy() for p in ds.pgo_poses]
    node.slam.system.pgm = types.SimpleNamespace(pgo_count=1)
    node.publish_msg()
    path = fake_ros.pubs["~pin_path"].msgs[-1]
    assert len(path.poses) == len(ds.pgo_poses) == 2
    assert path.poses[0].pose.position.x == pytest.approx(ds.pgo_poses[0][0, 3])
    node.publish_msg()                                 # no new PGO: appended
    assert len(fake_ros.pubs["~pin_path"].msgs[-1].poses) == 3
    node.slam.system.pgm = None

    # the watchdog: silence past the timeout after a frame ends the run
    sys.modules["rospy"].is_shutdown = lambda: False
    cfg.timeout_duration_s = 0
    node.out_dir = str(tmp_path / "final")
    node.spin()
    assert os.path.exists(os.path.join(node.out_dir, "map", "pin_map.npz"))


def test_main_without_rospy(monkeypatch, capsys):
    from pin_slam_torch import ros

    monkeypatch.setitem(sys.modules, "rospy", None)
    assert ros.main(["config/lidar_slam/run_ros_general.yaml"]) == 3
    assert "rospy is not available" in capsys.readouterr().err


def test_ros_general_profile_runs_under_fakes(tmp_path, fake_ros, monkeypatch):  # noqa: F811
    """``main`` builds the node for run_ros_general.yaml (no pc_path: frames
    come from the topic) and spins; the profile passes check_ported."""
    from pin_slam_torch import ros
    from pin_slam_torch.config import Config

    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    built = {}
    real = ros.PinSlamRosNode

    class Node(real):
        def __init__(self, cfg, cloud_topic=None, init_node=True, device=None):
            cfg.map_capacity, cfg.local_map_capacity = 1 << 12, 1 << 10
            cfg.buffer_size, cfg.pool_capacity = 1 << 14, 1 << 12
            cfg.downsample_hash_size = 1 << 12
            cfg._derive()
            cfg.output_root = str(tmp_path)
            super().__init__(cfg, cloud_topic, init_node, device="cpu")
            built["node"] = self

        def spin(self):
            built["spun"] = True

    monkeypatch.setattr(ros, "PinSlamRosNode", Node)
    prof = os.path.join(ROOT, "config", "lidar_slam", "run_ros_general.yaml")
    assert ros.main([prof, "/velodyne_points"]) == 0
    node = built["node"]
    assert built["spun"] and "/velodyne_points" in fake_ros.subscribers
    assert node.cfg.deskew and isinstance(node.cfg, Config)
    assert node.slam.system.device.type == "cpu"
