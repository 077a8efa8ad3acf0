"""The port's own copy of the framework-free parts of
``pin_slam_tpu/dataset/io.py`` that it uses: point clouds (KITTI ``.bin``,
``.npy``, PLY, PCD and LAS, with their per-point timestamps where the file
has them), SemanticKITTI ``.label`` files, KITTI and TUM poses, KITTI
calibration files, and the PLY and LAS
writers (the map, point-cloud and mesh artifacts, byte-identical to the JAX
package's)."""

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


def read_tum_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: ts tx ty tz qx qy qz qw. Returns ([N,4,4], [N] ts)."""
    from scipy.spatial.transform import Rotation

    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    arr = np.asarray(rows, dtype=np.float64)
    ts, t, q = arr[:, 0], arr[:, 1:4], arr[:, 4:8]
    poses = np.tile(np.eye(4), (arr.shape[0], 1, 1))
    poses[:, :3, :3] = Rotation.from_quat(q).as_matrix()
    poses[:, :3, 3] = t
    return poses, ts


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


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Minimal PCD reader (ascii / binary, no compression)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode(errors="ignore").strip()
            if line.startswith("#"):
                continue
            k, _, v = line.partition(" ")
            header[k] = v
            if k == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        npts = int(header["POINTS"])
        tmap = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2",
                ("U", 4): "u4", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
        dt = np.dtype([(fld, "<" + tmap[(t, s)], (c,)) if c > 1 else (fld, "<" + tmap[(t, s)])
                       for fld, s, t, c in zip(fields, sizes, types, counts)])
        if header["DATA"] == "ascii":
            data = np.loadtxt(f, dtype=dt, max_rows=npts, ndmin=1)
        elif header["DATA"] == "binary":
            data = np.frombuffer(f.read(dt.itemsize * npts), dtype=dt)
        else:
            raise ValueError(f"unsupported PCD encoding {header['DATA']}")
        return {fld: np.ascontiguousarray(data[fld]) for fld in fields}


def write_pcd(path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None) -> None:
    """Binary PCD (v0.7) of float32 x, y, z and, if given, intensity: the
    layout ``read_pcd`` reads, and that Livox recordings converted to PCD use."""
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    data = np.asarray(points, np.float32)[:, :3]
    if intensity is not None:
        data = np.concatenate([data, np.asarray(intensity, np.float32).reshape(-1, 1)], 1)
    n = data.shape[0]
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              f"FIELDS {' '.join(fields)}\nSIZE {' '.join(['4'] * len(fields))}\n"
              f"TYPE {' '.join(['F'] * len(fields))}\nCOUNT {' '.join(['1'] * len(fields))}\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


# LAS point-record layouts (ASPRS LAS 1.0-1.4, uncompressed).  Formats 0-5
# share the 20-byte core; 6-10 the 30-byte core.  Only the fields this
# pipeline consumes (xyz / intensity / rgb / gps time) are named.
_LAS_CORE_05 = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
                ("flags", "u1"), ("cls", "u1"), ("scan_angle", "i1"),
                ("user", "u1"), ("src", "<u2")]
_LAS_CORE_610 = [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
                 ("ret", "u1"), ("flags", "u1"), ("cls", "u1"), ("user", "u1"),
                 ("scan_angle", "<i2"), ("src", "<u2"), ("gps", "<f8")]
_LAS_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_LAS_POINT_DTYPES = {
    0: _LAS_CORE_05,
    1: _LAS_CORE_05 + [("gps", "<f8")],
    2: _LAS_CORE_05 + _LAS_RGB,
    3: _LAS_CORE_05 + [("gps", "<f8")] + _LAS_RGB,
    6: _LAS_CORE_610,
    7: _LAS_CORE_610 + _LAS_RGB,
    8: _LAS_CORE_610 + _LAS_RGB + [("nir", "<u2")],
}


def read_las(path: str) -> Dict[str, np.ndarray]:
    """Minimal pure-numpy ASPRS LAS reader (uncompressed; point formats 0-3,
    6-8).  Returns at least x/y/z (f64 world units) and intensity;
    red/green/blue and gps time when the format has them."""
    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file (bad signature)")
        offset_to_points = int(np.frombuffer(header[96:100], "<u4")[0])
        fmt = header[104] & 0x3F  # high bits flag LAZ compression
        if header[104] & 0xC0:
            raise ValueError(f"{path}: LAZ-compressed LAS is not supported")
        rec_len = int(np.frombuffer(header[105:107], "<u2")[0])
        n_points = int(np.frombuffer(header[107:111], "<u4")[0])
        ver = (header[24], header[25])
        if n_points == 0 and ver >= (1, 4) and len(header) >= 255:
            n_points = int(np.frombuffer(header[247:255], "<u8")[0])
        scale = np.frombuffer(header[131:155], "<f8").copy()
        off = np.frombuffer(header[155:179], "<f8").copy()
        if fmt not in _LAS_POINT_DTYPES:
            raise ValueError(f"{path}: unsupported LAS point format {fmt}")
        base = np.dtype(_LAS_POINT_DTYPES[fmt])
        if rec_len < base.itemsize:
            raise ValueError(f"{path}: record length {rec_len} < expected "
                             f"{base.itemsize} for format {fmt}")
        fields = dict(_LAS_POINT_DTYPES[fmt])
        if rec_len > base.itemsize:  # trailing extra bytes per record
            fields["_extra"] = (f"V{rec_len - base.itemsize}",)
        dt = np.dtype([(k, *(v if isinstance(v, tuple) else (v,)))
                       for k, v in fields.items()])
        f.seek(offset_to_points)
        data = np.frombuffer(f.read(dt.itemsize * n_points), dtype=dt,
                             count=n_points)
    out = {
        "x": data["X"] * scale[0] + off[0],
        "y": data["Y"] * scale[1] + off[1],
        "z": data["Z"] * scale[2] + off[2],
        "intensity": data["intensity"].astype(np.float32),
    }
    if "red" in dt.names:
        for c in ("red", "green", "blue"):
            out[c] = data[c].astype(np.float32) / 65535.0
    if "gps" in dt.names:
        out["gps_time"] = data["gps"].copy()
    return out


def write_las(path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              gps_time: Optional[np.ndarray] = None,
              scale: float = 1e-4) -> None:
    """Minimal LAS 1.2 writer (point format picked from the given attributes).
    Byte-identical to the JAX package's."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    fmt = (3 if (colors is not None and gps_time is not None) else
           2 if colors is not None else 1 if gps_time is not None else 0)
    dt = np.dtype(_LAS_POINT_DTYPES[fmt])
    off = points.min(axis=0) if n else np.zeros(3)
    rec = np.zeros(n, dtype=dt)
    q = np.rint((points - off) / scale).astype(np.int64)
    rec["X"], rec["Y"], rec["Z"] = (q[:, 0].astype(np.int32),
                                    q[:, 1].astype(np.int32),
                                    q[:, 2].astype(np.int32))
    if intensity is not None:
        rec["intensity"] = np.clip(np.asarray(intensity).reshape(-1), 0, 65535
                                   ).astype(np.uint16)
    if colors is not None:
        c = np.asarray(colors, np.float64)
        if c.max(initial=0.0) <= 1.0:
            c = c * 65535.0
        rec["red"], rec["green"], rec["blue"] = (
            c[:, 0].astype(np.uint16), c[:, 1].astype(np.uint16),
            c[:, 2].astype(np.uint16))
    if gps_time is not None:
        rec["gps"] = np.asarray(gps_time, np.float64)

    header = bytearray(227)
    header[0:4] = b"LASF"
    header[24], header[25] = 1, 2
    header[26:30] = b"PIN "
    header[58:62] = b"PIN "
    header[94:96] = np.uint16(227).tobytes()
    header[96:100] = np.uint32(227).tobytes()
    header[104] = fmt
    header[105:107] = np.uint16(dt.itemsize).tobytes()
    header[107:111] = np.uint32(n).tobytes()
    header[131:155] = np.full(3, scale, np.float64).tobytes()
    header[155:179] = off.astype(np.float64).tobytes()
    mins, maxs = (points.min(axis=0), points.max(axis=0)) if n else (off, off)
    header[179:227] = np.stack([maxs, mins], axis=1).reshape(-1).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def read_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """(points [N,3] float32, colours / intensity [N,C] or None, per-point
    timestamps [N] float64 or None) by extension: PLY ``timestamp`` /
    ``time`` / ``t``, PCD ``t``, LAS GPS time."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        raw = read_kitti_bin(path)
        return raw[:, :3], raw[:, 3:4], None
    if ext == ".npy":
        raw = np.load(path)
        return (raw[:, :3].astype(np.float32),
                raw[:, 3:4].astype(np.float32) if raw.shape[1] > 3 else None, None)
    if ext == ".ply":
        d = read_ply(path)
        pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
        color = None
        if all(k in d for k in ("red", "green", "blue")):
            color = np.stack([d["red"], d["green"], d["blue"]], axis=1).astype(np.float32)
            if color.max() > 1.0:
                color /= 255.0
        elif "intensity" in d:
            color = d["intensity"].astype(np.float32)[:, None]
        ts = None
        for key in ("timestamp", "time", "t"):
            if key in d:
                ts = d[key].astype(np.float64)
                break
        return pts, color, ts
    if ext == ".pcd":
        d = read_pcd(path)
        pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
        color = d["intensity"].astype(np.float32)[:, None] if "intensity" in d else None
        ts = d["t"].astype(np.float64) if "t" in d else None
        return pts, color, ts
    if ext == ".las":
        d = read_las(path)
        pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
        if "red" in d:
            color = np.stack([d["red"], d["green"], d["blue"]], axis=1).astype(np.float32)
        else:
            color = d["intensity"][:, None]
            if color.max(initial=0.0) > 1.0:
                color = color / max(color.max(), 1.0)
        ts = d.get("gps_time")
        return pts, color, ts
    raise ValueError(f"unsupported point cloud format: {path}")


def read_semantic_labels(path: str) -> np.ndarray:
    """A SemanticKITTI ``.label`` file (uint32 a point): the lower 16 bits,
    the raw semantic class, as int32."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32)


def read_kitti_calib(path: str) -> Dict[str, np.ndarray]:
    """KITTI calib file -> dict of 4x4 matrices; key 'Tr' maps lidar->camera."""
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            v = np.fromstring(vals, sep=" ")
            if v.size == 12:
                T = np.eye(4)
                T[:3, :] = v.reshape(3, 4)
                calib[key.strip()] = T
    return calib


def apply_kitti_calib(poses_cam: np.ndarray, Tr: np.ndarray) -> np.ndarray:
    """Move camera-frame GT poses into the LiDAR frame: Tr^-1 @ T @ Tr."""
    Tr_inv = np.linalg.inv(Tr)
    return np.einsum("ij,njk,kl->nil", Tr_inv, poses_cam, Tr)
