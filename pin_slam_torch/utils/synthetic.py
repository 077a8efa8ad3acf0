"""Synthetic LiDAR scenes for smoke runs and tests: a dense cluttered
corridor world, a smooth sensor trajectory, and an occlusion-aware scan
simulator (a copy of the JAX package's bench scene, ``bench.py``, so the port
and the JAX package can be driven with identical frames); and the square-loop
scene of the JAX package's loop-closure test, in memory, and its
surfaces (``square_world``)."""

import numpy as np


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

    n_az, n_el = 900, 64
    scans, poses = [], []
    for p, hd in waypoints:
        c, sn = np.cos(hd), np.sin(hd)
        T = np.eye(4)
        T[:3, :3] = [[c, -sn, 0], [sn, c, 0], [0, 0, 1]]
        T[:3, 3] = p
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
