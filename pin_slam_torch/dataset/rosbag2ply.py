"""Extract sensor_msgs/PointCloud2 frames from a ROS1 bag into per-frame PLY
files, without ROS: a pure-Python rosbag v2.0 record parser (the reader of
the JAX package's ``scripts/rosbag2ply.py``, kept here so that the port
imports nothing of that package), writing through the port's ``write_ply``.

Usage:
    python -m pin_slam_torch.dataset.rosbag2ply <input.bag> <output_dir> [topic]

Supports uncompressed and bz2-compressed chunks (lz4 if the lz4 package is
importable).  Each frame is written as ``<output_dir>/<stamp>.ply`` with
x, y, z (+ intensity when the cloud carries it), so the folder drops
straight into a profile's ``pc_path``.
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from pin_slam_torch.dataset import io as pio

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_CHUNK = 0x05
OP_CONNECTION = 0x07

_DATATYPE = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
             5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def _read_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _records(buf: bytes):
    """Yield (header_dict, data_bytes) records from a record stream."""
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _read_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _decompress(compression: str, data: bytes) -> bytes:
    if compression in ("none", ""):
        return data
    if compression == "bz2":
        import bz2

        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame

            return lz4.frame.decompress(data)
        except ImportError as e:
            raise RuntimeError("bag uses lz4 chunks and the lz4 package is not "
                               "importable; re-record with bz2/none") from e
    raise RuntimeError(f"unknown chunk compression {compression!r}")


def read_pointcloud2_frames(bag_path: str, topic: str = ""):
    """Yield (stamp_str, points (N,3) f32, intensity (N,) f32 | None)."""
    with open(bag_path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise RuntimeError(f"not a ROS1 v2.0 bag: {magic!r}")
        blob = f.read()

    connections = {}     # conn id -> (topic, type)

    def handle(header, data):
        op = header.get("op", b"\x00")[0]
        if op == OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            for h2, d2 in _records(_decompress(comp, data)):
                yield from handle(h2, d2)
        elif op == OP_CONNECTION:
            (conn,) = struct.unpack("<I", header["conn"])
            sub = _read_header(data)
            connections[conn] = (header.get("topic", b"").decode(),
                                 sub.get("type", b"").decode())
        elif op == OP_MSG:
            (conn,) = struct.unpack("<I", header["conn"])
            ctopic, ctype = connections.get(conn, ("", ""))
            if ctype != "sensor_msgs/PointCloud2":
                return
            if topic and ctopic != topic:
                return
            sec, nsec = struct.unpack("<II", header["time"])
            yield f"{sec}.{nsec:09d}", data

    for header, data in _records(blob):
        for stamp, raw in handle(header, data) or ():
            yield (stamp,) + _decode_pointcloud2(raw)


def _decode_pointcloud2(buf: bytes):
    """Deserialize a sensor_msgs/PointCloud2 message body."""
    off = 4 + 8                                   # header.seq + stamp
    (flen,) = struct.unpack_from("<I", buf, off)  # frame_id string
    off += 4 + flen
    height, width = struct.unpack_from("<II", buf, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = []
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        name = buf[off:off + nlen].decode()
        off += nlen
        foffset, fdtype, fcount = struct.unpack_from("<IBI", buf, off)
        off += 9
        fields.append((name, foffset, fdtype, fcount))
    (is_bigendian,) = struct.unpack_from("<B", buf, off)
    off += 1
    if is_bigendian:
        raise RuntimeError(
            "big-endian PointCloud2 messages are not supported")
    point_step, row_step = struct.unpack_from("<II", buf, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    raw = np.frombuffer(buf, np.uint8, dlen, off)
    if row_step != width * point_step and height >= 1 and row_step > 0:
        # rows may carry legal padding past width*point_step: slice the
        # dense payload of each row
        rows = raw[: height * row_step].reshape(height, row_step)
        raw = rows[:, : width * point_step].reshape(-1, point_step)
    else:
        raw = raw.reshape(-1, point_step)

    def column(name):
        for fname, foff, fdt, _ in fields:
            if fname == name:
                dt = _DATATYPE[fdt]
                w = np.dtype(dt).itemsize
                return raw[:, foff:foff + w].copy().view(dt)[:, 0].astype(np.float32)
        return None

    x, y, z = column("x"), column("y"), column("z")
    if x is None or y is None or z is None:
        raise RuntimeError("PointCloud2 without x/y/z fields")
    pts = np.stack([x, y, z], axis=1)
    ok = np.isfinite(pts).all(axis=1)
    inten = column("intensity")
    return pts[ok], (inten[ok] if inten is not None else None)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    bag_path, out_dir = argv[0], argv[1]
    topic = argv[2] if len(argv) > 2 else ""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for stamp, pts, inten in read_pointcloud2_frames(bag_path, topic):
        extra = {"intensity": inten} if inten is not None else None
        pio.write_ply(os.path.join(out_dir, f"{stamp}.ply"), pts, extra=extra)
        count += 1
    print(f"wrote {count} frames to {out_dir}")
    return 0 if count else 1


if __name__ == "__main__":
    raise SystemExit(main())
