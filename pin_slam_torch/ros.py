"""Online / streaming SLAM node of the PyTorch port, the counterpart of the
repository's ``pin_slam_ros.py`` (reference pin_slam_ros.py:44-491):

    python -m pin_slam_torch.ros <config.yaml> [cloud_topic]

The compute core is transport-agnostic (``StreamingSlam``): push point
cloud frames from any source, get poses and map artifacts back.  When
``rospy`` is importable the same core runs as a ROS 1 node
(``PinSlamRosNode``) that subscribes to ``PointCloud2`` and publishes TF,
odometry, the path, the frame's mapping and registration clouds and a
decimated neural-point map, with ``save_results`` / ``save_mesh`` services
and a silence watchdog.  Without ``rospy`` the command exits with code 3;
the streaming core stays usable.

Like the JAX package's node, ``push_frame`` crops the frame by range and
height, caps it at ``frame_bucket`` points with a subsample drawn from
``np.random.default_rng(frame_id)`` and pads it: it does not call the
dataset's ``preprocess_frame``, so there is no deskewing (it takes no point
times) and no voxel downsampling or adaptive range (ROADMAP C 17).  The
system runs on the GPU unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


class StreamingSlam:
    """Push-based SLAM run, the ROS-independent core of the node.

        s = StreamingSlam(cfg)
        for cloud in source:                    # (N, 3) or (N, 3 + C) numpy
            pose = s.push_frame(cloud)          # 4x4 world <- sensor
        s.finish("./out_dir")
    """

    def __init__(self, config, device=None):
        from pin_slam_torch.dataset.slam_dataset import SLAMDataset
        from pin_slam_torch.slam.pipeline import SlamSystem
        from pin_slam_torch.utils.platform import resolve_device

        dev = resolve_device(device)
        config.pc_path = ""  # no frames on disk
        self.dataset = SLAMDataset(config, device=dev)
        self.system = SlamSystem(config, dataset=self.dataset, device=dev)
        self.config = config
        self.last_msg_time = time.time()
        self.last_mapping_cloud = None

    def push_frame(self, points: np.ndarray) -> np.ndarray:
        """Process one sensor frame; returns the current pose estimate."""
        from pin_slam_torch.dataset.slam_dataset import Frame
        from pin_slam_torch.ops.voxel import pad_to

        cfg = self.config
        self.last_msg_time = time.time()
        xyz = np.asarray(points, dtype=np.float32)[:, :3]
        colors = (np.asarray(points[:, 3:3 + max(cfg.color_channel, 1)], dtype=np.float32)
                  if cfg.color_on and points.shape[1] > 3 else None)

        d = np.linalg.norm(xyz, axis=1)
        keep = (d > cfg.min_range) & (d < cfg.max_range) \
            & (xyz[:, 2] > cfg.min_z) & (xyz[:, 2] < cfg.max_z)
        xyz = xyz[keep]
        colors = colors[keep] if colors is not None else None
        if xyz.shape[0] > cfg.frame_bucket:
            idx = np.random.default_rng(self.system.frame_id).choice(
                xyz.shape[0], cfg.frame_bucket, replace=False)
            xyz = xyz[idx]
            colors = colors[idx] if colors is not None else None

        pad_pts, valid = pad_to(xyz, cfg.frame_bucket)
        pad_col = pad_to(colors, cfg.frame_bucket)[0] if colors is not None else None
        frame = Frame(pad_pts, valid, xyz.shape[0], colors=pad_col)
        self.last_mapping_cloud = xyz        # the cropped mapping cloud, sensor frame
        self.system.process_frame(frame)
        return self.system.cur_pose.copy()

    def neural_point_cloud(self, down_rate: int = None) -> np.ndarray:
        """The neural point map decimated by a prime stride for publishing;
        the stride follows the map's size along the reference's ladder
        (``publish_np_map_down_rate_list``, one step per 500 k points).
        One copy to the host."""
        count = int(self.system.state.count)
        if down_rate is None:
            ladder = self.config.publish_np_map_down_rate_list
            down_rate = ladder[min(count // 500000, len(ladder) - 1)]
        return self.system.state.positions[:count:down_rate].cpu().numpy()

    def finish(self, out_dir: str) -> dict:
        """Write the results and the end-of-run artifacts (the reference's
        save_results / save_mesh services); always saves the map."""
        self.config.save_map = True
        metrics = self.dataset.write_results(out_dir)
        self.system.save_artifacts(out_dir)
        return metrics


def _pose_to_quat_t(pose: np.ndarray):
    """4x4 -> ((qx, qy, qz, qw), t), on the host."""
    from pin_slam_torch.ops.transforms import rotmat_to_quat

    q = rotmat_to_quat(torch.as_tensor(np.asarray(pose[:3, :3], np.float32))).numpy()  # wxyz
    return (float(q[1]), float(q[2]), float(q[3]), float(q[0])), pose[:3, 3]


class PinSlamRosNode:
    """ROS 1 node around ``StreamingSlam`` with the reference's publishers
    and services (ref pin_slam_ros.py:44-148, 278-391): TF, odometry, the
    path (rebuilt from the pose graph after each PGO), the frame's mapping
    and registration clouds, the decimated neural-point map, the
    ``save_results`` / ``save_mesh`` services and the silence watchdog.

    Every ROS module is imported in ``__init__``, so the class builds under
    a faked ``rospy`` and nothing needs ROS to import this module."""

    def __init__(self, cfg, cloud_topic: str = None, init_node: bool = True, device=None):
        import rospy
        import nav_msgs.msg as nav_msgs
        import sensor_msgs.point_cloud2 as pc2
        import std_msgs.msg as std_msgs
        import tf2_ros
        from geometry_msgs.msg import PoseStamped, TransformStamped
        from nav_msgs.msg import Odometry
        from sensor_msgs.msg import PointCloud2, PointField
        from std_srvs.srv import Empty, EmptyResponse

        self._rospy = rospy
        self._msgs = dict(
            Path=nav_msgs.Path, Odometry=Odometry, PoseStamped=PoseStamped,
            TransformStamped=TransformStamped, PointCloud2=PointCloud2,
            PointField=PointField, Header=std_msgs.Header, EmptyResponse=EmptyResponse)
        self._pc2 = pc2

        if init_node:
            rospy.init_node("pin_slam_torch")
        self.global_frame_name = rospy.get_param("~global_frame_name", "map")
        self.sensor_frame_name = rospy.get_param("~sensor_frame_name", "range_sensor")
        self.cfg = cfg
        self.slam = StreamingSlam(cfg, device=device)
        self.out_dir = cfg.output_root or "./experiments/ros_run"

        q = 10
        self.traj_pub = rospy.Publisher("~pin_path", nav_msgs.Path, queue_size=q)
        self.path_msg = nav_msgs.Path()
        self.path_msg.header.frame_id = self.global_frame_name
        self.odom_pub = rospy.Publisher("~odometry", Odometry, queue_size=q)
        self.frame_input_pub = rospy.Publisher("~frame/input", PointCloud2, queue_size=q)
        self.frame_map_pub = rospy.Publisher("~frame/mapping", PointCloud2, queue_size=q)
        self.frame_reg_pub = rospy.Publisher("~frame/registration", PointCloud2, queue_size=q)
        self.map_pub = rospy.Publisher("~map/neural_points", PointCloud2, queue_size=q)
        self.tf_broadcaster = tf2_ros.TransformBroadcaster()

        rospy.Service("~save_results", Empty, self._save_results_cb)
        rospy.Service("~save_mesh", Empty, self._save_mesh_cb)

        topic = cloud_topic or rospy.get_param("~cloud_topic", "/points")
        rospy.Subscriber(topic, PointCloud2, self.frame_callback, queue_size=4)
        self._last_pgo_count = 0

    # ---- services (ref pin_slam_ros.py:119-148) ----
    def _save_results_cb(self, _req):
        self._rospy.loginfo("pin_slam_torch: save_results service")
        self.slam.dataset.write_results(self.out_dir)
        return self._msgs["EmptyResponse"]()

    def _save_mesh_cb(self, _req):
        self._rospy.loginfo("pin_slam_torch: save_mesh service")
        save_mesh_prev = self.cfg.save_mesh
        self.cfg.save_mesh = True
        self.slam.system.save_artifacts(self.out_dir)
        self.cfg.save_mesh = save_mesh_prev
        return self._msgs["EmptyResponse"]()

    # ---- per-frame path ----
    def frame_callback(self, msg):
        pts = np.asarray(list(self._pc2.read_points(
            msg, field_names=("x", "y", "z"), skip_nans=True)), dtype=np.float32)
        if pts.size == 0:
            return
        self.slam.push_frame(pts)
        self.publish_msg(msg)

    def _xyz_cloud(self, frame_id: str, pts: np.ndarray):
        PointField, Header = self._msgs["PointField"], self._msgs["Header"]
        fields = [PointField("x", 0, PointField.FLOAT32, 1),
                  PointField("y", 4, PointField.FLOAT32, 1),
                  PointField("z", 8, PointField.FLOAT32, 1)]
        header = Header()
        header.stamp = self._rospy.Time.now()
        header.frame_id = frame_id
        return self._pc2.create_cloud(header, fields, pts.astype(np.float32))

    def _pose_msg(self, pose: np.ndarray):
        (qx, qy, qz, qw), t = _pose_to_quat_t(pose)
        msg = self._msgs["PoseStamped"]()
        msg.header.stamp = self._rospy.Time.now()
        msg.header.frame_id = self.global_frame_name
        o = msg.pose.orientation
        o.x, o.y, o.z, o.w = qx, qy, qz, qw
        p = msg.pose.position
        p.x, p.y, p.z = map(float, t)
        return msg

    def publish_msg(self, input_pc_msg=None):
        """TF, odometry, path and the map / frame clouds (ref
        pin_slam_ros.py:278-391)."""
        rospy = self._rospy
        cfg = self.cfg
        slam = self.slam
        pose_msg = self._pose_msg(slam.system.cur_pose)

        odom_msg = self._msgs["Odometry"]()
        odom_msg.header = pose_msg.header
        odom_msg.child_frame_id = self.sensor_frame_name
        odom_msg.pose.pose = pose_msg.pose
        self.odom_pub.publish(odom_msg)

        tf_msg = self._msgs["TransformStamped"]()
        tf_msg.header.stamp = rospy.Time.now()
        tf_msg.header.frame_id = self.global_frame_name
        tf_msg.child_frame_id = self.sensor_frame_name
        r, o = tf_msg.transform.rotation, pose_msg.pose.orientation
        r.x, r.y, r.z, r.w = o.x, o.y, o.z, o.w
        tr, p = tf_msg.transform.translation, pose_msg.pose.position
        tr.x, tr.y, tr.z = p.x, p.y, p.z
        self.tf_broadcaster.sendTransform(tf_msg)

        # the path: appended, or rebuilt from the pose graph after a PGO
        # correction (ref pin_slam_ros.py:315-336)
        pgm = slam.system.pgm
        pgo_count = pgm.pgo_count if pgm is not None else 0
        if pgo_count > self._last_pgo_count:
            self._last_pgo_count = pgo_count
            self.path_msg.poses = [self._pose_msg(p) for p in slam.dataset.pgo_poses]
        else:
            self.path_msg.poses.append(pose_msg)
        self.path_msg.header.stamp = rospy.Time.now()
        self.traj_pub.publish(self.path_msg)

        if cfg.publish_np_map:
            self.map_pub.publish(self._xyz_cloud(self.global_frame_name,
                                                 slam.neural_point_cloud()))
        if slam.last_mapping_cloud is not None:
            self.frame_map_pub.publish(self._xyz_cloud(self.sensor_frame_name,
                                                       slam.last_mapping_cloud))
        # the registration source cloud (from frame 1 on), sensor frame
        if slam.system.last_source is not None:
            src, src_valid = slam.system.last_source[:2]
            self.frame_reg_pub.publish(self._xyz_cloud(self.sensor_frame_name,
                                                       src[src_valid].cpu().numpy()))
        if cfg.republish_raw_input and input_pc_msg is not None:
            input_pc_msg.header = self._xyz_cloud(self.sensor_frame_name,
                                                  np.zeros((0, 3))).header
            self.frame_input_pub.publish(input_pc_msg)

    def spin(self):
        """Wait for frames; after ``timeout_duration_s`` of silence (once a
        frame came) finish the run (ref pin_slam_ros.py:243-255)."""
        rospy = self._rospy
        rate = rospy.Rate(2)
        while not rospy.is_shutdown():
            if (time.time() - self.slam.last_msg_time > self.cfg.timeout_duration_s
                    and self.slam.system.frame_id > 0):
                break
            rate.sleep()
        self.slam.finish(self.out_dir)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        import rospy  # noqa: F401
    except ImportError:
        print("pin_slam_torch.ros: rospy is not available in this environment.\n"
              "The streaming core is importable as pin_slam_torch.ros.StreamingSlam:\n"
              "push numpy frames directly, or run the batch CLI: python -m pin_slam_torch.cli",
              file=sys.stderr)
        return 3

    from pin_slam_torch.config import Config

    # the reference's arguments: <config> [cloud_topic] (ref pin_slam_ros.py:470-491)
    cfg = Config()
    if argv:
        cfg.load(argv[0])
    node = PinSlamRosNode(cfg, cloud_topic=argv[1] if len(argv) > 1 else None)
    node.spin()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
