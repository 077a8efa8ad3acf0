"""The ``ncd_os0_128.quad`` cell driven end to end on the CPU, through
``slambench.harness.run_cell`` as the benchmark builds the program (the
timed generator's five-column scans into ``SLAMDataset``,
``SlamSystem.process_frame``), at a size a test run holds: 32 beams x 256
columns, capacities and the batch cut, BA every 6 frames over 6 poses.  A
sound run deskews every frame after the first with the handed times, runs
BA, and is correct under limits set from another sound run; with the
control planted it is not."""

import time

import pytest

from slambench import faults, harness

CELL = "ncd_os0_128.quad"
SMALL_SENSOR = {"blocks": [[45.0, -45.0, 32]], "columns": 256}
SMALL_CONFIG = dict(map_capacity=1 << 16, local_map_capacity=1 << 14, pool_capacity=1 << 18,
                    frame_bucket=8192, source_bucket=2048, bs=2048, buffer_size=1 << 20,
                    downsample_hash_size=1 << 16, ba_freq_frame=6, ba_frame=6)
WARM, FRAMES, SECONDS = 4, 14, 1.0e4
LIMIT_OVER_SOUND = 3.0


def small_run(plant=None, seed=2 ** 35 + 23, limits=None, watch=None):
    spec = harness.load_cell(CELL)
    spec.cell.update(warm_frames=WARM, ate_frames=4, max_fps=(FRAMES - WARM) / SECONDS,
                     trace={"frames": 2},
                     sample={"frames": 6, "points": 256, "offset_m": 0.3})
    if limits is not None:
        spec.cell["limits"] = limits
    return harness.run_cell(spec, seed, SECONDS, False, "cpu", time.perf_counter(),
                            overrides=SMALL_CONFIG, sensor=SMALL_SENSOR, plant=plant or watch)


@pytest.fixture(scope="module")
def limits():
    keys = harness.load_cell(CELL).cell["limits"]
    sound = small_run()["readings"]
    return {k: LIMIT_OVER_SOUND * max(sound[k], 1e-3) for k in keys}


def test_a_sound_run_deskews_adjusts_and_is_correct(limits):
    seen = {"deskew": [], "ba": []}

    def watch(system):
        from pin_slam_torch.dataset import slam_dataset

        orig_deskew, orig_ba = slam_dataset.deskew_points, system._bundle_adjustment

        def deskew(points, ts, motion, *a, **kw):
            seen["deskew"].append(ts.detach().clone())
            return orig_deskew(points, ts, motion, *a, **kw)

        def ba():
            out = orig_ba()
            seen["ba"].append(out)
            return out
        slam_dataset.deskew_points, system._bundle_adjustment = deskew, ba

        def undo():
            slam_dataset.deskew_points = orig_deskew
            del system._bundle_adjustment
        return undo

    res = small_run(seed=2 ** 35 + 24, limits=limits, watch=watch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == FRAMES - WARM     # the window runs until the sequence ends
    # every frame after the first deskews, with the generator's column times
    assert len(seen["deskew"]) == FRAMES - 1
    cols = SMALL_SENSOR["columns"]
    for ts in seen["deskew"]:
        assert float(ts.min()) >= 0.5 / cols and float(ts.max()) <= 1.0 - 0.5 / cols
        assert bool(((ts * cols - 0.5).round() == ts * cols - 0.5).all())
    # BA ran at frames 5 and 11 (a batch's loss is too noisy at this size
    # to fall in every call: the card's runs show that)
    assert [b["iters"] for b in seen["ba"]] == [60, 60]
    assert all(b["loss_finite"] and b["mean_pose_shift_m"] < 0.05 for b in seen["ba"])


def test_the_control_is_not_correct(limits):
    res = small_run(faults.PLANTS[faults.CONTROL], limits=limits)
    assert not res["correct"], res["checks"]
