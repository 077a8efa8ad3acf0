"""The port's own copy of the framework-free parts of
``pin_slam_tpu/dataset/io.py`` that it uses: KITTI scans and poses, PLY read
and write (the map, point-cloud and mesh artifacts, byte-identical to the
JAX package's), and TUM poses."""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def natural_sort(names: List[str]) -> List[str]:
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]
    return sorted(names, key=key)


def read_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: [N,4] x, y, z, intensity."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """(points [N,3], intensity [N,1], timestamps None); only KITTI .bin and
    .npy are ported."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        raw = read_kitti_bin(path)
        return raw[:, :3], raw[:, 3:4], None
    if ext == ".npy":
        raw = np.load(path)
        return (raw[:, :3].astype(np.float32),
                raw[:, 3:4].astype(np.float32) if raw.shape[1] > 3 else None, None)
    from pin_slam_torch.utils.platform import not_ported

    raise not_ported(f"point cloud format {ext}")


def read_kitti_poses(path: str) -> np.ndarray:
    """Each line 12 floats (3x4 row-major), optionally led by a timestamp.
    Returns [N,4,4] float64."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    if data.shape[1] == 13:
        data = data[:, 1:]
    n = data.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :] = data.reshape(n, 3, 4)
    return poses


def write_kitti_poses(path: str, poses: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9f}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")


def write_tum_poses(path: str, poses: np.ndarray, timestamps=None) -> None:
    from scipy.spatial.transform import Rotation

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            ts = timestamps[i] if timestamps is not None else float(i)
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            t = T[:3, 3]
            f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Minimal PLY reader returning the vertex element's properties by name."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    cur[2].append((tok[4].decode(), "list", tok[2].decode(), tok[3].decode()))
                else:
                    cur[2].append((tok[2].decode(), _PLY_DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break

        out: Dict[str, np.ndarray] = {}
        endian = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            if any(len(p) == 4 for p in props):  # list property (faces)
                if fmt == "ascii":
                    rows = [np.fromstring(f.readline(), sep=" ") for _ in range(count)]
                    faces = np.asarray([r[1:] for r in rows], dtype=np.int64)
                else:
                    (pname, _, cnt_t, item_t) = props[0]
                    cnt_dt = np.dtype(endian + _PLY_DTYPES[cnt_t])
                    item_dt = np.dtype(endian + _PLY_DTYPES[item_t])
                    faces = []
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                        faces.append(np.frombuffer(f.read(item_dt.itemsize * k), item_dt))
                    faces = np.asarray(faces, dtype=np.int64)
                if name == "face":
                    out["faces"] = faces
                continue
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            if fmt == "ascii":
                data = np.loadtxt(f, dtype=dt, max_rows=count, ndmin=1)
            else:
                data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
            if name == "vertex":
                for p in props:
                    out[p[0]] = np.ascontiguousarray(data[p[0]])
        return out


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None, faces: Optional[np.ndarray] = None,
              extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Binary-little-endian PLY writer (points + optional colors/normals/faces)."""
    n = points.shape[0]
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [colors[:, 0], colors[:, 1], colors[:, 2]]
    if extra:
        for k, v in extra.items():
            props.append((k, "f4"))
            cols.append(v.astype(np.float32))
    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
    rec = np.empty(n, dtype=dt)
    for (pname, _), c in zip(props, cols):
        rec[pname] = c

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        type_names = {"f4": "float", "u1": "uchar"}
        head += [f"property {type_names[p[1]]} {p[0]}" for p in props]
        if faces is not None:
            head += [f"element face {faces.shape[0]}",
                     "property list uchar int vertex_indices"]
        head.append("end_header")
        f.write(("\n".join(head) + "\n").encode())
        f.write(rec.tobytes())
        if faces is not None:
            frec = np.empty(faces.shape[0], dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            frec["n"] = 3
            frec["v"] = faces.astype(np.int32)
            f.write(frec.tobytes())
