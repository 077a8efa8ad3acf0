"""The port's RGB-D converters (pin_slam_torch/dataset/converters.py)
against the JAX package's on the CPU: the depth back-projection on random
images, and each dataset converter (Replica, TUM RGB-D, NeuralRGBD) on a
tiny folder of 16-bit depth and 8-bit colour images written with PIL.  The
written PLY frames and poses.txt must be byte-equal, the back-projected
points and colours bit-exact."""

import os

import numpy as np
import pytest
from PIL import Image

from pin_slam_torch.dataset import converters as tc
from pin_slam_tpu.dataset import converters as jc


def _images(rng, H=24, W=40, zero_frac=0.2):
    depth = rng.integers(1, 40000, (H, W)).astype(np.uint16)
    depth[rng.random((H, W)) < zero_frac] = 0
    color = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    return depth, color


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("with_color", [True, False])
def test_backproject_depth_bit_exact(stride, with_color):
    rng = np.random.default_rng(stride)
    depth, color = _images(rng)
    col = color if with_color else None
    args = (depth, 60.0, 61.0, 19.5, 11.5)
    jp, jcol = jc.backproject_depth(*args, col, depth_scale=6553.5, stride=stride)
    tp, tcol = tc.backproject_depth(*args, col, depth_scale=6553.5, stride=stride)
    assert tp.dtype == jp.dtype == np.float32 and tp.shape[0] > 0
    np.testing.assert_array_equal(tp, jp)
    if with_color:
        assert tcol.dtype == jcol.dtype == np.float32
        np.testing.assert_array_equal(tcol, jcol)
    else:
        assert tcol is None and jcol is None


def test_backproject_depth_float_colour_passes_through():
    rng = np.random.default_rng(9)
    depth, _ = _images(rng)
    col = rng.random(depth.shape + (3,)).astype(np.float32)
    tp, tcol = tc.backproject_depth(depth, 60.0, 60.0, 19.5, 11.5, col, depth_scale=1000.0,
                                    max_depth=30.0)
    jp, jcol = jc.backproject_depth(depth, 60.0, 60.0, 19.5, 11.5, col, depth_scale=1000.0,
                                    max_depth=30.0)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tcol, jcol)


def _poses(rng, n):
    out = []
    for _ in range(n):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        T = np.eye(4)
        T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        T[:3, 3] = rng.uniform(-2, 2, 3)
        out.append(T)
    return np.stack(out)


def _write_replica(root, rng, n):
    res = os.path.join(root, "results")
    os.makedirs(res)
    for i in range(n):
        depth, color = _images(rng)
        Image.fromarray(depth).save(os.path.join(res, f"depth{i:06d}.png"))
        if i != 1:                 # a frame without its colour image
            Image.fromarray(color).save(os.path.join(res, f"frame{i:06d}.jpg"))
    np.savetxt(os.path.join(root, "traj.txt"), _poses(rng, n).reshape(n, 16))


def _write_tum(root, rng, n):
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb, dep, gt = [], [], []
    for i in range(n):
        depth, color = _images(rng)
        t = 100.0 + 0.05 * i
        Image.fromarray(color).save(os.path.join(root, "rgb", f"{t:.6f}.png"))
        # one frame's depth too far from its colour image: skipped
        td = t + (0.005 if i != 2 else 0.04)
        Image.fromarray(depth).save(os.path.join(root, "depth", f"{td:.6f}.png"))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        gt.append(f"{t + 0.001:.6f} " + " ".join(f"{v:.6f}" for v in rng.uniform(-1, 1, 3))
                  + " " + " ".join(f"{v:.6f}" for v in q))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gt)):
        with open(os.path.join(root, name), "w") as f:
            f.write("# a comment\n" + "\n".join(lines) + "\n")


def _write_neuralrgbd(root, rng, n, depth_dir):
    os.makedirs(os.path.join(root, depth_dir))
    os.makedirs(os.path.join(root, "images"))
    for i in range(n):
        depth, color = _images(rng)
        Image.fromarray(depth).save(os.path.join(root, depth_dir, f"depth{i}.png"))
        Image.fromarray(color).save(os.path.join(root, "images", f"img{i}.png"))
    with open(os.path.join(root, "focal.txt"), "w") as f:
        f.write("55.5\n")
    np.savetxt(os.path.join(root, "poses.txt"), _poses(rng, n).reshape(-1, 4))


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


CASES = {
    "replica": (_write_replica, "convert_replica", {}),
    "tum": (_write_tum, "convert_tum", {}),
    "neuralrgbd": (lambda r, g, n: _write_neuralrgbd(r, g, n, "depth"), "convert_neuralrgbd", {}),
    "neuralrgbd_filtered": (lambda r, g, n: _write_neuralrgbd(r, g, n, "depth_filtered"),
                            "convert_neuralrgbd", {}),
    "replica_stride1_max2": (_write_replica, "convert_replica",
                             {"stride": 1, "max_frames": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_writes_the_jax_files(case, tmp_path):
    write, fn, kw = CASES[case]
    src = str(tmp_path / "src")
    os.makedirs(src)
    write(src, np.random.default_rng(len(case)), 4)
    counts = {}
    for name, mod in (("jax", jc), ("torch", tc)):
        counts[name] = getattr(mod, fn)(src, str(tmp_path / name), **kw)
    assert counts["torch"] == counts["jax"] > 0
    jt, tt = _tree_bytes(str(tmp_path / "jax")), _tree_bytes(str(tmp_path / "torch"))
    assert sorted(tt) == sorted(jt)
    assert len([k for k in tt if k.endswith(".ply")]) == counts["torch"]
    for k in jt:
        assert tt[k] == jt[k], k


def test_converter_command_line(tmp_path, capsys):
    """``python -m pin_slam_torch.dataset.converters replica <in> <out>``
    writes what ``convert_replica`` writes."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    _write_replica(src, np.random.default_rng(5), 3)
    assert tc.main(["replica", src, str(tmp_path / "cli"), "--max_frames", "2"]) == 0
    assert "converted 2 replica frames" in capsys.readouterr().out
    tc.convert_replica(src, str(tmp_path / "fn"), max_frames=2)
    assert _tree_bytes(str(tmp_path / "cli")) == _tree_bytes(str(tmp_path / "fn"))
