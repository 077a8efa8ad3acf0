"""The port's sliding-window bundle adjustment held to the benchmark's plain
reference (``slambench/reference_deskew_ba.py``, float64, exact kNN):
``mapper.ba_value_and_grad``'s loss and gradients at seeded random
features, decoder weights and pose corrections, three iterations of
``mapper.bundle_adjustment_loop`` against the reference's Adam, and the
BA's spans and iteration count in the frame's report.

The state is the port's own after four frames of the pipeline tests' tiny
scene with BA at frame 3.  The two sides are compared at the samples where
the port's hash probe picks the same neighbours as exact kNN, and that lie
farther than 1 mm from every neighbour (there the weight 1 / (d^2 + 1e-15)
and its gradient rest on the rounding of d^2)."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from slambench import reference as ref
from slambench import reference_deskew_ba as rd
from test_torch_pipeline import _config, _frames

torch.set_num_threads(1)
F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_AT = 4                 # BA at frame 3: a window of 3 poses after the fixed frame 0


@pytest.fixture(scope="module")
def ba_run():
    """(system, infos) after four frames, BA at the last."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, False)
    cfg.ba_freq_frame, cfg.ba_frame = BA_AT, BA_AT
    cfg._derive()
    system = SlamSystem(cfg, device="cpu")
    system.tc = dataclasses.replace(system.tc, min_valid_ratio=0.1)
    infos = [system.process_frame(Frame(arr, valid, n)) for arr, valid, n in _frames(BA_AT)]
    return system, infos


def _inputs(system, seed):
    """The system's local map and pool with seeded random features (the
    sentinel row zero), decoder weights and the window's poses."""
    g = torch.Generator().manual_seed(seed)
    lm, mc = system.lm, system.mc
    L = mc.local_capacity
    feats = torch.randn(lm.geo_features.shape, generator=g) * 0.3
    feats[L] = 0.0
    decoder = system.decoder
    with torch.no_grad():
        for p in decoder.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(max(p.shape[0], 1)))
    poses = np.stack(system.dataset.odom_poses)
    poses_full = np.tile(np.eye(4, dtype=np.float32), (1 << 10, 1, 1))
    poses_full[:len(poses)] = poses.astype(np.float32)
    window = 3
    return dict(lm=lm, mc=mc, mcfg=system.mcfg, decoder=decoder, offsets=system.offsets,
                pool=system.pool, feats=feats, poses_full=torch.as_tensor(poses_full),
                window_start=len(poses) - window, window=window, gen=g)


def _check_script():
    spec = importlib.util.spec_from_file_location(
        "_ncd_reference_check", os.path.join(ROOT, "scripts", "ncd_reference_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECK = _check_script()


def _snapshot(p, feats):
    return CHECK.ba_snapshot(p["lm"], p["mc"], p["mcfg"], feats, p["decoder"])


def _batch(p, idx, xi):
    """The batch's (local, ts, valid) as the loop reads them, and the mask of
    the samples compared: valid, the same neighbours both ways, off every
    neural point (the chip check's own selection)."""
    b = CHECK.ba_samples(p["lm"], p["mc"], p["mcfg"], p["feats"], p["decoder"], p["pool"],
                         p["offsets"], p["poses_full"], p["window_start"], xi, idx)
    return b["local"], b["ts"], b["valid"], b["compared"]


@pytest.mark.parametrize("seed", [1, 2])
def test_ba_value_and_grad_against_reference(ba_run, seed):
    """The loss within 1e-5 of itself, the gradients in the features and in
    the window's corrections within 1e-4 of their largest entry, at random
    features, decoder weights and corrections."""
    from pin_slam_torch.slam import mapper as mp

    p = _inputs(ba_run[0], seed)
    xi = torch.randn((p["window"], 6), generator=p["gen"]) * 0.01
    idx = torch.randint(0, int(p["pool"].fill), (4096,), generator=p["gen"])
    local, ts, valid, both = _batch(p, idx, xi)
    assert int(both.sum()) > 0.5 * int(valid.sum()) > 200
    assert int((ts[both] >= p["window_start"]).sum()) > 100
    loss, g_f, g_x = mp.ba_value_and_grad(p["lm"], p["mc"], p["mcfg"], p["offsets"],
                                          p["decoder"], p["feats"], xi, p["poses_full"],
                                          p["window_start"], local, ts, both)
    r_loss, r_f, r_x, _ = rd.ba_loss_and_grads(_snapshot(p, p["feats"]), p["poses_full"],
                                               p["window_start"], xi, local, ts, both)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * float(r_loss)
    for got, want in ((g_f, r_f), (g_x, r_x)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got.double() - want).abs().max()) <= 1e-4 * scale
    # the gradients are not trivially equal: moving xi moves the loss
    _, _, g_x0, _ = rd.ba_loss_and_grads(_snapshot(p, p["feats"]), p["poses_full"],
                                         p["window_start"], torch.zeros_like(xi), local, ts, both)
    assert float((g_x0 - r_x).abs().max()) > 1e-3 * float(r_x.abs().max())


def test_ba_loop_three_iterations_against_reference_adam(ba_run):
    """Three iterations of ``bundle_adjustment_loop`` from xi = 0 on batches
    of compared samples: the losses within 1e-5, the corrections within 1e-3
    of their largest entry, and the features' change within 1e-3 of the
    largest at every entry whose first gradient is not within rounding of 0
    (Adam with eps 1e-15 takes a full step of either sign there).  The rate
    is cut to 1e-4, so that the samples move by well under a millimetre and
    keep the neighbours both sides pick at the start (checked at the end)."""
    from pin_slam_torch.slam import mapper as mp

    p = _inputs(ba_run[0], 3)
    p["mcfg"] = dataclasses.replace(p["mcfg"], lr=1e-4)
    xi0 = torch.zeros((p["window"], 6))
    idx = torch.randint(0, int(p["pool"].fill), (3, 16384), generator=p["gen"])
    picks, batches = [], []
    for t in range(3):
        local, ts, valid, both = _batch(p, idx[t], xi0)
        pick = idx[t][both][:512]
        assert pick.numel() == 512
        picks.append(pick)
        local, ts, valid, both = _batch(p, pick, xi0)
        assert bool(both.all())
        batches.append((local, ts, valid, None))
    feats, xi, losses = mp.bundle_adjustment_loop(
        p["lm"], p["mc"], p["feats"].clone(), p["decoder"], p["pool"], p["mcfg"], p["offsets"],
        p["poses_full"], p["window_start"], xi0, torch.stack(picks))
    snap = _snapshot(p, p["feats"])
    r_feats, r_xi, r_losses = rd.adam_steps(snap, p["poses_full"], p["window_start"], xi0,
                                            batches, p["mcfg"].lr, p["mcfg"].adam_eps)
    for t in range(3):
        assert bool(_batch(p, picks[t], r_xi.float())[3].all())
    np.testing.assert_allclose(losses.double().numpy(), r_losses, rtol=1e-5)
    assert float((xi.double() - r_xi).abs().max()) <= 1e-3 * float(r_xi.abs().max())
    _, g_f, _, _ = rd.ba_loss_and_grads(snap, p["poses_full"], p["window_start"], xi0,
                                        *batches[0][:3])
    moved = r_feats - snap.features
    firm = g_f.abs() > 1e-9 * float(g_f.abs().max())
    assert int(firm.sum()) > 100
    err = (feats.double() - p["feats"].double() - moved).abs()
    assert float(err[firm].max()) <= 1e-3 * float(moved.abs().max())
    assert not feats[p["mc"].local_capacity].any()


def test_ba_spans_and_count_in_the_report(ba_run):
    """The BA frame's report holds the loop and the refresh spans inside
    ``pin_slam.pgo.ba``, the pool pass's span inside the refresh, and
    ``ba.iters`` (4 x iters) and one ``pool.passes``; the frames before it
    hold none of them, nor a deskew's."""
    system, infos = ba_run
    rep = infos[BA_AT - 1]["trace"]
    spans = rep["span_ms"]
    assert {"pin_slam.pgo.ba", "pin_slam.pgo.ba.loop", "pin_slam.pgo.ba.refresh"} <= set(spans)
    assert spans["pin_slam.pgo.ba.loop"] + spans["pin_slam.pgo.ba.refresh"] \
        <= spans["pin_slam.pgo.ba"]
    assert spans["pin_slam.pgo.ba.pool"] <= spans["pin_slam.pgo.ba.refresh"]
    assert rep["counts"]["ba.iters"] == 4 * system.config.iters == infos[BA_AT - 1]["ba"]["iters"]
    assert rep["counts"]["pool.passes"] == 1
    for info in infos[:BA_AT - 1]:
        r = info["trace"]
        assert not any(k.startswith("pin_slam.pgo.ba") or k == "pin_slam.dataset.deskew"
                       for k in r["span_ms"])
        assert "ba.iters" not in r["counts"] and "pool.passes" not in r["counts"]
