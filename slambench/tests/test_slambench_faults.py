"""A run driven end to end on the CPU at a size a test run holds, past the
harness's look for a card: sound, it is correct under limits on the cell's
numbers set from another sound run; with the control or a fault planted
underneath the timed path, ``correct`` comes out false.  The loaded modules hold neither JAX nor the JAX package,
and the reference loads nothing of the port."""

import subprocess
import sys
import time

import pytest

from slambench import faults, harness

# the start of kitti_hdl64.drive at a size the CPU runs in about a second
# a frame: 64 beams (the HDL-64E's two blocks) x 512 columns, capacities and
# the batch cut to fit; the sequence holds FRAMES frames and the window runs
# until they are spent, whatever the CPU's speed
CELL = "kitti_hdl64.drive"
SMALL_SENSOR = {"blocks": [[2.0, -8.33, 32], [-8.83, -24.8, 32]], "columns": 512}
SMALL_CONFIG = dict(map_capacity=1 << 16, local_map_capacity=1 << 14, pool_capacity=1 << 18,
                    frame_bucket=8192, source_bucket=2048, bs=2048, buffer_size=1 << 20,
                    downsample_hash_size=1 << 16)
WARM, FRAMES, SECONDS = 4, 16, 1.0e4
# the small run's limits: these multiples of a sound small run's readings
# (the cell's own limits are set from full-size runs on the card)
LIMIT_OVER_SOUND = 3.0


def small_run(plant=None, seed=2 ** 35 + 11, limits=None):
    spec = harness.load_cell(CELL)
    spec.cell.update(warm_frames=WARM, ate_frames=4, max_fps=(FRAMES - WARM) / SECONDS,
                     trace={"frames": 2},
                     sample={"frames": 6, "points": 256, "offset_m": 0.3})
    if limits is not None:
        spec.cell["limits"] = limits
    return harness.run_cell(spec, seed, SECONDS, False, "cpu", time.perf_counter(),
                            overrides=SMALL_CONFIG, sensor=SMALL_SENSOR, plant=plant)


@pytest.fixture(scope="module")
def limits():
    keys = harness.load_cell(CELL).cell["limits"]
    sound = small_run()["readings"]
    return {k: LIMIT_OVER_SOUND * max(sound[k], 1e-3) for k in keys}


def test_a_sound_run_is_correct(limits):
    res = small_run(seed=2 ** 35 + 12, limits=limits)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("plant", sorted(faults.PLANTS))
def test_control_and_faults_are_not_correct(plant, limits):
    res = small_run(faults.PLANTS[plant], limits=limits)
    assert not res["correct"], (plant, res["checks"])


def test_no_jax_in_a_run_and_no_port_in_the_reference():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, %r)\n"
        "import slambench.reference, slambench.generators.lidar_scene\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('pin_slam_torch', 'pin_slam_tpu', 'jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n"
        "from slambench.tests import test_slambench_faults as t\n"
        "t.small_run()\n"
        "from slambench import harness\n"
        "print(harness.forbidden_loaded(list(sys.modules)))\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
