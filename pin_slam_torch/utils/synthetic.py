"""Synthetic LiDAR scenes for smoke runs and tests: a dense cluttered
corridor world, a smooth sensor trajectory, and an occlusion-aware scan
simulator (a copy of the JAX package's bench scene, ``bench.py``, so the port
and the JAX package can be driven with identical frames); the square-loop
scene of the JAX package's loop-closure test, in memory, and its
surfaces (``square_world``); a rolling-sweep renderer (``rolling_sweep``,
``make_square_sweeps``), whose points are measured from the pose at their
own sweep time, as a spinning LiDAR moving through the scene measures them;
writers of a sequence in the KITTI and the Newer College (NCD) layouts on
disk; and an RGB-D renderer (a painted room seen by a pinhole camera with
Replica's intrinsics, ``render_rgbd``) with a writer of the layout the
RGB-D converters write (``write_rgbd_sequence``)."""

import os

import numpy as np

from pin_slam_torch.dataset import converters


def make_world(rng):
    """Dense cluttered corridor world: ground + walls + pillar clutter, each
    point carrying its outward surface normal so scans can backface-cull
    (LiDAR never sees the far side of a surface; without culling, free-space
    samples of see-through rays contradict the surface labels and poison the
    SDF).  Returns (points (N,3), normals (N,3))."""
    pts, nrm = [], []
    g = np.column_stack([rng.uniform(-15, 45, 60000), rng.uniform(-15, 15, 60000),
                         -1.5 + 0.02 * rng.standard_normal(60000)])
    pts.append(g)
    nrm.append(np.tile([0.0, 0.0, 1.0], (60000, 1)))
    for axis, lo_hi, sign in [(1, (-15, 45), -15.0), (1, (-15, 45), 15.0),
                              (0, (-15, 15), -15.0), (0, (-15, 15), 45.0)]:
        w = np.empty((60000, 3))
        w[:, 1 if axis == 1 else 0] = sign + 0.05 * rng.standard_normal(60000)
        w[:, 0 if axis == 1 else 1] = rng.uniform(*lo_hi, 60000)
        w[:, 2] = rng.uniform(-1.5, 3.0, 60000)
        pts.append(w)
        n = np.zeros((60000, 3))
        n[:, 1 if axis == 1 else 0] = -np.sign(sign)   # walls face inward
        nrm.append(n)
    for _ in range(40):
        cx, cy = rng.uniform(-12, 42), rng.uniform(-12, 12)
        if abs(cy) < 2.5:
            continue  # keep the corridor free
        radius = rng.uniform(0.8, 2.0)
        ang = rng.uniform(0, 2 * np.pi, 3000)
        p = np.column_stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang),
                             rng.uniform(-1.5, 2.0, 3000)])
        pts.append(p)
        nrm.append(np.column_stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)]))
    # thick "building" boxes flanking the corridor: their +-x faces constrain
    # the travel direction (without them the corridor is a textbook degenerate
    # geometry and the eigenvalue health gate rightly rejects every
    # registration); thick boxes avoid the thin-surface label conflicts that
    # behind-surface samples create
    for bx in np.arange(-10.0, 42.0, 7.0):
        for side in (-1.0, 1.0):
            by = side * rng.uniform(4.0, 9.0)
            wx, wy = rng.uniform(2.5, 4.5), rng.uniform(2.5, 4.5)
            for axis, face_sign in [(0, -1), (0, 1), (1, -1), (1, 1)]:
                m = 5000
                f = np.empty((m, 3))
                half = (wx, wy)[axis]
                f[:, axis] = (bx, by)[axis] + face_sign * half \
                    + 0.02 * rng.standard_normal(m)
                f[:, 1 - axis] = rng.uniform(-(wx, wy)[1 - axis],
                                             (wx, wy)[1 - axis], m) + (bx, by)[1 - axis]
                f[:, 2] = rng.uniform(-1.5, 3.5, m)
                pts.append(f)
                n = np.zeros((m, 3))
                n[:, axis] = face_sign
                nrm.append(n)
    return np.concatenate(pts).astype(np.float32), np.concatenate(nrm).astype(np.float32)


def sensor_pose(i):
    """Smooth trajectory with slow-start ramp: up to ~0.5 m/frame + gentle yaw."""
    s = 0.5 * sum(min(1.0, (k + 1) / 5.0) for k in range(i))
    yaw = 0.004 * i
    R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                  [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    t = np.array([s, 0.5 * np.sin(0.1 * i), 0.02 * np.sin(0.3 * i)])
    return R, t


def lidar_scan(rng, world, origin, R, n_pts, max_range=20.0,
               n_az=900, n_el=96):
    """Visible world points in the SENSOR frame.  Occlusion is resolved with a
    spherical depth buffer (nearest point per azimuth/elevation bin — the same
    thing a spinning LiDAR measures), plus backface culling for surface
    orientation.  world: (points, normals)."""
    points, normals = world
    local = (points - origin) @ R
    dist = np.linalg.norm(local, axis=1)
    facing = np.einsum("ij,ij->i", origin - points, normals) > 0
    keep = (dist > 2.0) & (dist < max_range) & facing
    pts, d = local[keep], dist[keep]

    az = np.arctan2(pts[:, 1], pts[:, 0])                     # [-pi, pi)
    el = np.arcsin(np.clip(pts[:, 2] / d, -1.0, 1.0))
    ia = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(np.int64), 0, n_az - 1)
    ie = np.clip(((el + 0.6) / 1.2 * n_el).astype(np.int64), 0, n_el - 1)
    bins = ia * n_el + ie
    order = np.argsort(d, kind="stable")                      # nearest first
    _, first = np.unique(bins[order], return_index=True)
    pts = pts[order[first]]

    sub = rng.choice(pts.shape[0], min(n_pts, pts.shape[0]), replace=False)
    return pts[sub].astype(np.float32)


def square_world(rng, side=8.0):
    """The square-loop scene's surfaces: (points (N,3), outward normals (N,3)),
    drawn first from ``rng`` by ``make_square_scene``."""
    world, normals = [], []
    g = rng.uniform([-15, -15, 0], [15, 15, 0], size=(20000, 3))
    g[:, 2] = -1.5 + 0.02 * rng.standard_normal(20000)
    world.append(g)
    normals.append(np.tile([0.0, 0.0, 1.0], (20000, 1)))
    for axis, sign in [(0, -15.0), (0, 15.0), (1, -15.0), (1, 15.0)]:
        n_w = 30000
        w = np.empty((n_w, 3))
        w[:, axis] = sign + 0.05 * rng.standard_normal(n_w)
        w[:, 1 - axis] = rng.uniform(-15, 15, n_w)
        w[:, 2] = rng.uniform(-1.5, 2.0, n_w)
        world.append(w)
        nv = np.zeros((n_w, 3))
        nv[:, axis] = -np.sign(sign)          # walls face inward
        normals.append(nv)
    for _ in range(70):
        cx, cy = rng.uniform(-13, 13, 2)
        if abs(abs(cx) - side / 2) < 1.5 and abs(cy) < side / 2 + 1.5:
            continue                          # keep the path corridor free
        if abs(abs(cy) - side / 2) < 1.5 and abs(cx) < side / 2 + 1.5:
            continue
        radius = rng.uniform(0.3, 1.2)
        ang = rng.uniform(0, 2 * np.pi, 4000)
        world.append(np.column_stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang),
                                      rng.uniform(-1.5, 1.5, 4000)]))
        normals.append(np.column_stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)]))
    return (np.concatenate(world).astype(np.float32),
            np.concatenate(normals).astype(np.float32))


def square_waypoints(side=8.0, step=0.8):
    """The square-loop scene's path: [(position (3,), heading)] for every
    frame, a rounded square of side ``side`` driven once around and along
    the first leg again (a genuine revisit), ``step`` m a frame on the
    straights after a slow start, 0.15 m on the corner arcs."""
    # rounded-square centreline parameterised by arc length, so the path
    # closes exactly; the corner radius keeps the turn rate near 5 deg/frame
    r = 1.6
    straight = side - 2 * r
    L_total = 4 * (straight + np.pi / 2 * r)

    def pose_at(s):
        s = s % L_total
        x0, y0 = -side / 2 + r, -side / 2
        corners = [(side / 2 - r, -side / 2 + r), (side / 2 - r, side / 2 - r),
                   (-side / 2 + r, side / 2 - r), (-side / 2 + r, -side / 2 + r)]
        headings = [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]
        pos = np.array([x0, y0, 0.0])
        for leg in range(4):
            hd = headings[leg]
            d = np.array([np.cos(hd), np.sin(hd), 0.0])
            if s <= straight:
                return pos + d * s, hd
            s -= straight
            cx, cy = corners[leg]
            arc = np.pi / 2 * r
            if s <= arc:
                a = hd - np.pi / 2 + s / r
                return np.array([cx + r * np.cos(a), cy + r * np.sin(a), 0.0]), hd + s / r
            s -= arc
            a0 = hd - np.pi / 2
            pos = np.array([cx + r * np.cos(a0 + np.pi / 2), cy + r * np.sin(a0 + np.pi / 2), 0.0])
        return pos, 0.0

    waypoints, s, frame = [], 0.0, 0
    while s < L_total + straight * 0.8:       # one full loop + the revisit
        p, hd = pose_at(s)
        waypoints.append((p, hd))
        seg_pos = (s % L_total) % (straight + np.pi / 2 * r)
        on_arc = seg_pos > straight
        v = (0.15 if on_arc else step) * min(1.0, (frame + 1) / 5.0)
        if not on_arc and seg_pos + v > straight:
            v = (straight - seg_pos) + 0.15   # enter the corner arc gently
        s += v
        frame += 1

    return waypoints


def pose_matrix(p, heading):
    """World <- sensor 4x4 of a planar pose (position, heading about z)."""
    c, sn = np.cos(heading), np.sin(heading)
    T = np.eye(4)
    T[:3, :3] = [[c, -sn, 0], [sn, c, 0], [0, 0, 1]]
    T[:3, 3] = p
    return T


def make_square_scene(rng, side=8.0, step=0.8):
    """The square-loop scene of the JAX package's loop-closure test
    (``tests/test_full_slam.py``), in memory: a rounded square path of side
    ``side`` in a cluttered 30 x 30 m room, driven once around and along the
    first leg again (a genuine revisit), with occlusion-aware, backface-culled
    scans.  Draws from ``rng`` in the same order as the on-disk version (the
    intensity column included), so a seed gives the same frames.

    Returns (scans: list of (N, 4) float32 [x, y, z, intensity] in the sensor
    frame, poses (n, 4, 4) float64 world <- sensor)."""
    world, normals = square_world(rng, side)

    waypoints = square_waypoints(side, step)
    n_az, n_el = 900, 64
    scans, poses = [], []
    for p, hd in waypoints:
        T = pose_matrix(p, hd)
        poses.append(T)
        Tinv = np.linalg.inv(T)
        local = world @ Tinv[:3, :3].T + Tinv[:3, 3]
        dist = np.linalg.norm(local, axis=1)
        facing = np.einsum("ij,ij->i", p - world, normals) > 0
        keep = (dist > 2.0) & (dist < 20.0) & facing
        pts, d = local[keep], dist[keep]
        # spherical depth buffer: the nearest return per az/el bin (occlusion)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        el = np.arcsin(np.clip(pts[:, 2] / d, -1.0, 1.0))
        ia = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(np.int64), 0, n_az - 1)
        ie = np.clip(((el + 0.6) / 1.2 * n_el).astype(np.int64), 0, n_el - 1)
        order = np.argsort(d, kind="stable")
        _, first = np.unique((ia * n_el + ie)[order], return_index=True)
        pts = pts[order[first]]
        sub = rng.choice(pts.shape[0], min(15000, pts.shape[0]), replace=False)
        scans.append(np.concatenate(
            [pts[sub], rng.uniform(0, 1, (sub.size, 1)).astype(np.float32)],
            axis=1).astype(np.float32))
    return scans, np.stack(poses)


# ----------------------------------------------------------------------
# rolling sweeps
# ----------------------------------------------------------------------


def _so3_exp(w):
    """Rodrigues for axis-angle rows w (N,3) -> (N,3,3), float64."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    K = np.zeros((w.shape[0], 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    K[:, 1, 0], K[:, 2, 0], K[:, 2, 1] = w[:, 2], -w[:, 1], w[:, 0]
    small = th < 1e-12
    safe = np.where(small, 1.0, th)
    A = np.where(small, 1.0, np.sin(safe) / safe)
    B = np.where(small, 0.5, (1.0 - np.cos(safe)) / safe ** 2)
    return np.eye(3)[None] + A * K + B * (K @ K)


def _so3_log(R):
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (0.5 if th < 1e-12 else th / (2.0 * np.sin(th)))


def sweep_time(p):
    """Sweep time in [0, 1] of sensor-frame points (N,3): a clockwise spin
    starting behind the sensor (the time ``recover_point_ts`` assumes)."""
    return (-np.arctan2(p[:, 1], p[:, 0]) / np.pi + 1.0) / 2.0


def rolling_sweep(world, T_mid, T_rel, n_az=1024, n_el=128, fov=(-0.3927, 0.3927),
                  min_range=2.0, max_range=60.0, n_iter=2):
    """One sweep of a spinning LiDAR of ``n_az`` x ``n_el`` beams (vertical
    field of view ``fov`` rad) whose mid-sweep pose is ``T_mid`` (world <-
    sensor) and which moves by ``T_rel`` (the pose at the sweep's end in the
    frame at its start; the constant velocity between neighbouring frames)
    during one sweep.  The sensor's pose at sweep time u in [-0.5, 0.5]
    (u = 0 at mid-sweep) is T_mid @ T_rel(u), T_rel(u) = (exp(u log R_rel),
    u t_rel): the motion that ``deskew_points`` undoes.  Each surface point
    facing the sensor is measured from the pose at its own time, found by a
    fixed-point iteration between its azimuth and its time; the nearest
    return of each (azimuth, elevation) beam is kept.

    Returns (points (N,3) float32 in the sensor frame at each point's time,
    time (N,) in [0, 1], the points' true coordinates in the mid-sweep frame
    (N,3) float64)."""
    points, normals = world
    points = points.astype(np.float64)
    Rm, tm = T_mid[:3, :3], T_mid[:3, 3]
    p_mid = (points - tm) @ Rm
    d_mid = np.linalg.norm(p_mid, axis=1)
    facing = np.einsum("ij,ij->i", tm - points, normals) > 0
    keep = (d_mid > min_range) & (d_mid < max_range) & facing
    p_mid = p_mid[keep]
    w_rel, t_rel = _so3_log(T_rel[:3, :3]), T_rel[:3, 3]
    u = sweep_time(p_mid) - 0.5
    for _ in range(n_iter):
        R_u = _so3_exp(u[:, None] * w_rel[None, :])
        p_u = np.einsum("nji,nj->ni", R_u, p_mid - u[:, None] * t_rel)
        u = sweep_time(p_u) - 0.5
    R_u = _so3_exp(u[:, None] * w_rel[None, :])
    p_u = np.einsum("nji,nj->ni", R_u, p_mid - u[:, None] * t_rel)
    d = np.linalg.norm(p_u, axis=1)
    az = np.arctan2(p_u[:, 1], p_u[:, 0])
    el = np.arcsin(np.clip(p_u[:, 2] / d, -1.0, 1.0))
    ok = (el >= fov[0]) & (el < fov[1]) & (d > min_range) & (d < max_range)
    ia = np.clip(((az + np.pi) / (2 * np.pi) * n_az).astype(np.int64), 0, n_az - 1)
    ie = np.clip(((el - fov[0]) / (fov[1] - fov[0]) * n_el).astype(np.int64), 0, n_el - 1)
    cand = np.nonzero(ok)[0]
    order = cand[np.argsort(d[cand], kind="stable")]
    _, first = np.unique((ia * n_el + ie)[order], return_index=True)
    sel = np.sort(order[first])
    return p_u[sel].astype(np.float32), u[sel] + 0.5, p_mid[sel]


def make_square_sweeps(rng, side=8.0, step=0.8, n_az=1024, n_el=128, workers=1):
    """The square-loop scene's world (drawn from ``rng`` as
    ``make_square_scene`` draws it) and path, every frame rendered as a
    rolling sweep (``rolling_sweep``) under the constant velocity from the
    previous frame (from the next one for frame 0), on ``workers`` threads.
    Returns (scans: list of (N, 4) float32 [x, y, z, intensity], times: list
    of (N,) in [0, 1], true mid-sweep coordinates: list of (N, 3), poses
    (n, 4, 4) world <- sensor at mid-sweep)."""
    from concurrent.futures import ThreadPoolExecutor

    world = square_world(rng, side)
    poses = np.stack([pose_matrix(p, hd) for p, hd in square_waypoints(side, step)])

    def render(i):
        T_rel = (np.linalg.inv(poses[i - 1]) @ poses[i] if i > 0
                 else np.linalg.inv(poses[0]) @ poses[1])
        return rolling_sweep(world, poses[i], T_rel, n_az=n_az, n_el=n_el)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        sweeps = list(ex.map(render, range(len(poses))))
    scans, times, truth = [], [], []
    for pts, ts, mid in sweeps:
        inten = rng.uniform(0, 1, (pts.shape[0], 1)).astype(np.float32)
        scans.append(np.concatenate([pts, inten], axis=1))
        times.append(ts)
        truth.append(mid)
    return scans, times, truth, poses


# ----------------------------------------------------------------------
# sequences on disk
# ----------------------------------------------------------------------

# LiDAR -> camera extrinsics of KITTI odometry sequence 00 (its calib.txt "Tr")
KITTI_TR = np.array([
    [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
    [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
    [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
    [0.0, 0.0, 0.0, 1.0]])


def write_poses(path, poses):
    """Poses (n, 4, 4) as KITTI's 12 numbers a line, at full double
    precision (``io.write_kitti_poses`` writes 9 decimals)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.17g}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")


def write_kitti_sequence(root, seq, scans, poses, Tr=KITTI_TR):
    """A sequence in the KITTI odometry layout under ``root``:
    ``sequences/<seq>/velodyne/%06d.bin`` (x, y, z, intensity float32),
    ``sequences/<seq>/calib.txt`` with the LiDAR -> camera ``Tr``, and
    ``poses/<seq>.txt``: the LiDAR poses ``poses`` as KITTI gives ground
    truth, in the camera frame (Tr @ T @ Tr^-1), at full double precision.
    Returns the sequence's velodyne directory."""
    velo = os.path.join(root, "sequences", seq, "velodyne")
    os.makedirs(velo, exist_ok=True)
    for i, scan in enumerate(scans):
        s = np.zeros((scan.shape[0], 4), np.float32)
        s[:, :scan.shape[1]] = scan[:, :4]
        s.tofile(os.path.join(velo, f"{i:06d}.bin"))
    with open(os.path.join(root, "sequences", seq, "calib.txt"), "w") as f:
        for key in ("P0", "P1", "P2", "P3"):
            f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in np.eye(4)[:3].reshape(-1)) + "\n")
        f.write("Tr: " + " ".join(f"{v:.17g}" for v in Tr[:3].reshape(-1)) + "\n")
    Tr_inv = np.linalg.inv(Tr)
    write_poses(os.path.join(root, "poses", f"{seq}.txt"),
                 [Tr @ T @ Tr_inv for T in poses])
    return velo


def write_ncd_sequence(root, seq, scans, times, poses, sweep_s=0.1):
    """A sequence in the Newer College 128-beam layout under ``root``:
    ``<seq>/ply/%06d.ply`` (binary PLY with x, y, z, intensity and a
    per-point ``time`` in seconds from the sweep's start, ``sweep_s`` a
    sweep) and ``<seq>/poses.txt`` (LiDAR poses, KITTI's 12 numbers a
    line).  Returns the sequence's ply directory."""
    from pin_slam_torch.dataset import io as pio

    ply = os.path.join(root, seq, "ply")
    os.makedirs(ply, exist_ok=True)
    for i, (scan, ts) in enumerate(zip(scans, times)):
        extra = {"time": (np.asarray(ts) * sweep_s).astype(np.float32)}
        if scan.shape[1] > 3:
            extra = {"intensity": scan[:, 3], **extra}
        pio.write_ply(os.path.join(ply, f"{i:06d}.ply"), scan[:, :3], extra=extra)
    write_poses(os.path.join(root, seq, "poses.txt"), poses)
    return ply


# ----------------------------------------------------------------------
# RGB-D: a painted room seen by a pinhole camera with Replica's intrinsics
# ----------------------------------------------------------------------

# the room (x, y, z lower and upper bounds; z up) and boxes standing in it
RGBD_ROOM = (np.array([-3.0, -2.5, -1.2]), np.array([3.0, 2.5, 1.5]))
RGBD_BOXES = [(np.array([1.2, 0.8, -1.2]), np.array([2.0, 1.6, -0.3])),
              (np.array([-2.4, -1.9, -1.2]), np.array([-1.6, -1.1, 0.2])),
              (np.array([0.6, -2.1, -1.2]), np.array([1.6, -1.5, -0.6])),
              (np.array([-1.0, 1.6, -1.2]), np.array([-0.2, 2.3, 0.4])),
              # floor-to-ceiling pillars: faces across the view constrain
              # sideways motion
              (np.array([1.3, -1.3, -1.2]), np.array([1.6, -1.0, 1.5])),
              (np.array([2.0, 0.2, -1.2]), np.array([2.3, 0.5, 1.5])),
              (np.array([0.5, 1.3, -1.2]), np.array([0.8, 1.6, 1.5])),
              (np.array([2.4, -0.8, -1.2]), np.array([2.7, -0.5, 0.9]))]


def world_color(pts):
    """The colour field painted on the RGB-D room: the field of the JAX
    package's RGB-D test (``tests/test_rgbd.py``), in [0, 1]."""
    pts = np.asarray(pts)
    c = 0.5 + 0.5 * np.stack([np.sin(pts[:, 0] * 2.0), np.cos(pts[:, 1] * 2.0),
                              np.sin(pts[:, 2] * 3.0)], axis=1)
    return c.astype(np.float32)


def rgbd_pose(i, n_frames=41):
    """Camera -> world pose (4, 4) of frame ``i`` (OpenCV camera: x right,
    y down, z forward): a slow dolly across the room (about 3 cm a frame)
    with a swaying heading (up to 0.2 rad) and a slight downward tilt."""
    s = i / max(n_frames - 1, 1)
    pos = np.array([-1.0 + 1.2 * s, 0.3 * np.sin(2.0 * np.pi * s), 0.1 * np.sin(np.pi * s)])
    yaw = 0.2 * np.sin(2.0 * np.pi * s + 0.5)
    tilt = 0.15 + 0.05 * np.cos(2.0 * np.pi * s)
    fwd = np.array([np.cos(yaw) * np.cos(tilt), np.sin(yaw) * np.cos(tilt), -np.sin(tilt)])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, :3] = np.stack([right, down, fwd], axis=1)
    T[:3, 3] = pos
    return T


def _ray_box_exit(o, inv_d, lo, hi):
    """Ray parameter at which rays o + t d (``inv_d`` = 1 / d, one array a
    coordinate) starting inside [lo, hi] leave it."""
    t = [np.maximum((lo[a] - o[a]) * inv_d[a], (hi[a] - o[a]) * inv_d[a]) for a in range(3)]
    return np.minimum(np.minimum(t[0], t[1]), t[2])


def _ray_box_enter(o, inv_d, lo, hi):
    """Ray parameter at which rays starting outside [lo, hi] enter it (inf
    for a miss)."""
    near, far = None, None
    for a in range(3):
        t1, t2 = (lo[a] - o[a]) * inv_d[a], (hi[a] - o[a]) * inv_d[a]
        n_a, f_a = np.minimum(t1, t2), np.maximum(t1, t2)
        near = n_a if near is None else np.maximum(near, n_a)
        far = f_a if far is None else np.minimum(far, f_a)
    return np.where((near <= far) & (near > 0), near, np.inf)


def render_rgbd(T_wc, width=1200, height=680, fx=converters.REPLICA_FX,
                fy=converters.REPLICA_FY, cx=converters.REPLICA_CX, cy=converters.REPLICA_CY,
                depth_scale=converters.REPLICA_DEPTH_SCALE):
    """One RGB-D frame of the room from camera pose ``T_wc``: a uint16
    depth image (z-depth times ``depth_scale``, 0 where nothing is hit
    within range) and a uint8 colour image (the painted field at the hit
    point).  Defaults are Replica's camera."""
    v, u = np.meshgrid(np.arange(height, dtype=np.float64),
                       np.arange(width, dtype=np.float64), indexing="ij")
    xc, yc = ((u - cx) / fx).reshape(-1), ((v - cy) / fy).reshape(-1)
    R, o = T_wc[:3, :3], T_wc[:3, 3]
    d = [R[a, 0] * xc + R[a, 1] * yc + R[a, 2] for a in range(3)]   # unit z-depth per ray
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = [1.0 / x for x in d]       # +-inf along an axis the ray is parallel to
        t = _ray_box_exit(o, inv_d, *RGBD_ROOM)
        for lo, hi in RGBD_BOXES:
            t = np.minimum(t, _ray_box_enter(o, inv_d, lo, hi))
    hit = np.stack([o[a] + t * d[a] for a in range(3)], axis=1)
    depth = np.rint(t * depth_scale)
    depth = np.where(np.isfinite(t) & (depth < 65536), depth, 0).astype(np.uint16)
    color = np.rint(world_color(hit) * 255.0).astype(np.uint8)
    return depth.reshape(height, width), color.reshape(height, width, 3)


def write_rgbd_sequence(root, depths, colors, poses, stride=2,
                        intrinsics=(converters.REPLICA_FX, converters.REPLICA_FY,
                                    converters.REPLICA_CX, converters.REPLICA_CY),
                        depth_scale=converters.REPLICA_DEPTH_SCALE):
    """Rendered RGB-D frames as ``converters.convert_replica`` writes a
    Replica sequence: ``root/rgbd_ply/%06d.ply`` (the frames back-projected
    at ``stride`` by ``converters.backproject_depth``, x y z + RGB) and
    ``root/poses.txt`` (camera -> world, KITTI's 12 numbers a line).
    Returns the number of points of each frame."""
    from pin_slam_torch.dataset import io as pio

    fx, fy, cx, cy = intrinsics
    os.makedirs(os.path.join(root, "rgbd_ply"), exist_ok=True)
    counts = []
    for i, (depth, color) in enumerate(zip(depths, colors)):
        pts, cols = converters.backproject_depth(depth, fx, fy, cx, cy, color,
                                                 depth_scale=depth_scale, stride=stride)
        pio.write_ply(os.path.join(root, "rgbd_ply", f"{i:06d}.ply"), pts, colors=cols)
        counts.append(pts.shape[0])
    pio.write_kitti_poses(os.path.join(root, "poses.txt"), np.stack(poses))
    return counts
