"""The port's dataset tools against the JAX package's scripts on the same
inputs: ``python -m pin_slam_torch.dataset.convert_dataset`` (the flags of
``scripts/convert_dataset.py``) on tiny PIL-written Replica, TUM and
NeuralRGBD folders, and ``python -m pin_slam_torch.dataset.rosbag2ply`` (the
flags of ``scripts/rosbag2ply.py``) on a synthesized ROS1 v2.0 bag with a
bz2 chunk and a bare message record.  Every written file must be
byte-equal to the script's."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from test_rosbag2ply import _write_bag
from test_torch_converters import _tree_bytes, _write_neuralrgbd, _write_replica, _write_tum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WRITERS = {"replica": _write_replica, "tum": _write_tum,
           "neuralrgbd": lambda r, g, n: _write_neuralrgbd(r, g, n, "depth")}


@pytest.mark.parametrize("flags", [[], ["--max_frames", "2"], ["--down_sample"],
                                   ["--max_frames", "3", "--down_sample"]],
                         ids=["all", "max2", "down_sample", "max3_down_sample"])
@pytest.mark.parametrize("dataset", sorted(WRITERS))
def test_convert_dataset_writes_the_scripts_files(dataset, flags, tmp_path, monkeypatch):
    from pin_slam_torch.dataset import convert_dataset

    src = str(tmp_path / "src")
    os.makedirs(src)
    WRITERS[dataset](src, np.random.default_rng(len(dataset) + len(flags)), 4)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", ["convert_dataset.py", dataset, "--input_root", src,
                                      "--output_root", jout] + flags)
    _script("convert_dataset").main()
    assert convert_dataset.main([dataset, "--input_root", src, "--output_root", tout]
                                + flags) == 0
    jt, tt = _tree_bytes(jout), _tree_bytes(tout)
    n_ply = len([k for k in tt if k.endswith(".ply")])
    assert 0 < n_ply <= (int(flags[1]) if "--max_frames" in flags else 4)
    assert sorted(tt) == sorted(jt)
    for key in jt:
        assert tt[key] == jt[key], key


def _bag(tmp_path, seed):
    rng = np.random.default_rng(seed)
    clouds = [(rng.uniform(-10, 10, size=(n, 3)).astype(np.float32),
               rng.uniform(0, 1, n).astype(np.float32)) for n in (500, 333)]
    bag = str(tmp_path / "test.bag")
    _write_bag(bag, clouds)
    return bag


@pytest.mark.parametrize("topic", [["/points"], [], ["/other"]],
                         ids=["topic", "any_topic", "no_such_topic"])
def test_rosbag2ply_writes_the_scripts_files(topic, tmp_path):
    from pin_slam_torch.dataset import rosbag2ply

    bag = _bag(tmp_path, 3)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    rc_j = _script("rosbag2ply").main([bag, jout] + topic)
    rc_t = rosbag2ply.main([bag, tout] + topic)
    assert rc_t == rc_j == (1 if topic == ["/other"] else 0)
    jt, tt = _tree_bytes(jout), _tree_bytes(tout)
    assert sorted(tt) == sorted(jt) and len(tt) == (0 if rc_t else 2)
    for key in jt:
        assert tt[key] == jt[key], key


def test_tools_run_as_modules(tmp_path):
    """Both tools through ``python -m`` in a clean interpreter (usage, return
    code, the files) and neither imports JAX or the JAX package."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    _write_replica(src, np.random.default_rng(1), 2)
    bag = _bag(tmp_path, 4)
    env = {**os.environ, "PYTHONPATH": ROOT}
    code = ("import sys, runpy\n"
            "sys.argv = sys.argv[1:]\n"
            "runpy.run_module(sys.argv[0], run_name='__main__')\n")
    for argv, n in (
            (["pin_slam_torch.dataset.convert_dataset", "replica", "--input_root", src,
              "--output_root", str(tmp_path / "conv"), "--down_sample"], 2),
            (["pin_slam_torch.dataset.rosbag2ply", bag, str(tmp_path / "ply"), "/points"], 2)):
        out = subprocess.run([sys.executable, "-c", code + (
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pin_slam_tpu')]\n"
            "assert not bad, bad\n"), *argv], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    assert len([k for k in _tree_bytes(str(tmp_path / "conv")) if k.endswith(".ply")]) == 2
    assert len(os.listdir(tmp_path / "ply")) == 2
    usage = subprocess.run([sys.executable, "-m", "pin_slam_torch.dataset.rosbag2ply"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert usage.returncode == 2 and "Usage" in usage.stdout
