"""The tracker's cached Gauss-Newton step (``ops/track_kernel.py``) on the
CPU, where ``track_step`` runs its plain twin: the twin gives the tracker's
former step bit for bit, padded source rows add exact zeros, the route to
the kernel follows what the code can observe (``track_kernel_takes``), the
wrapper counts no launch off the card, and the benchmark's
``gn_kernel_share`` reads the program's counts.  The kernel itself is held
to the twin on the card (``chip_smoke.py``'s ``track_step`` phases)."""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[True, False], ids=["wf", "per_neighbor"])
def trained(request):
    """``tests/test_torch_tracker.py``'s map: the port trained on frame 0 of
    the synthetic corridor, frame 1's source cloud."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn

    cfg = Config()
    cfg.pgo_on, cfg.silence = False, True
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 17, 1 << 17
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, 1 << 13, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    cfg.weighted_first = request.param
    cfg._derive()
    s = SlamSystem(cfg, device="cpu")
    rng = np.random.default_rng(0)
    world = syn.make_world(np.random.default_rng(0))
    frames = []
    for i in range(2):
        R, t = syn.sensor_pose(i)
        pts = syn.lidar_scan(rng, world, t, R, 1 << 13)
        frames.append(pad_to(pts, 1 << 13))
    s.process_frame(Frame(frames[0][0], frames[0][1], 0))
    src, src_valid = s._source_prep(torch.as_tensor(frames[1][0]), torch.as_tensor(frames[1][1]))
    return dict(s=s, src=src, src_valid=src_valid, cfg=cfg)


def _pose(angle=0.01, shift=(0.08, 0.02, 0.0)):
    c, n = np.cos(angle), np.sin(angle)
    R = torch.tensor([[c, -n, 0.0], [n, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    return R, torch.tensor(shift, dtype=torch.float32)


def _step_inputs(trained, after_pgo, normals):
    """(cache, local map, normals, their validity, R, t) of one step near the
    true pose; after a pose-graph optimisation the map's quaternions are
    random unit ones."""
    from pin_slam_torch.ops.normals import estimate_normals
    from pin_slam_torch.slam import tracker_grad as tg

    s = trained["s"]
    lm = s.lm
    if after_pgo:
        q = torch.as_tensor(np.random.default_rng(3).normal(size=(lm.attr_rows.shape[0], 4)),
                            dtype=torch.float32)
        attr = lm.attr_rows.clone()
        attr[:, 3:7] = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        lm = dataclasses.replace(lm, attr_rows=attr)
    R, t = _pose()
    src, valid = trained["src"], trained["src_valid"]
    cache = tg.probe_candidates(lm, s.mc, src @ R.T + t + lm.origin, s.append_tmpl)
    nrm = nv = None
    if normals:
        nrm, nv = estimate_normals(src, valid, 0.2)
    return cache, lm, nrm, nv, R, t


def _former_step(cache, lm, mc, tc, decoder, sdf_scale, source, source_valid, R, t, after_pgo,
                 source_normals, source_normal_valid):
    """The tracker's cached step as it stood before the track-step kernel
    (``tracker.track_frame``'s ``one_step``, cached branch, no colour), kept
    here as the reference the twin must equal bit for bit."""
    from pin_slam_torch.ops.transforms import _cross
    from pin_slam_torch.slam import tracker_grad as tg

    def _gm_weight(k, r):
        return (k / (k * k + r * r)) ** 2

    origin = lm.origin
    max_sdf_std = tc.surface_sample_range * tc.max_sdf_std_ratio
    R_d, t_d = torch.as_tensor(R), torch.as_tensor(t)
    cur = source @ R_d.T + t_d
    sdf, grad, nn_count, sdf_std = tg.sdf_value_and_grad_cached(
        cache, lm, mc, decoder, sdf_scale, cur + origin, after_pgo)
    grad_norm = torch.linalg.norm(grad, dim=-1)
    mask = (source_valid & (nn_count >= tc.mask_min_nn_count)
            & (grad_norm > tc.min_grad_norm) & (grad_norm < tc.max_grad_norm)
            & (sdf_std < max_sdf_std))
    residual = sdf
    w = _gm_weight(tc.GM_dist, residual) * _gm_weight(tc.GM_grad, grad_norm - 1.0)
    if source_normals is not None:
        n_w = source_normals @ torch.as_tensor(R).T
        grad_unit = grad / torch.clamp(grad_norm, min=1e-12)[:, None]
        w_normal = 0.5 + torch.abs(torch.sum(n_w * grad_unit, dim=-1))
        if source_normal_valid is not None:
            w_normal = torch.where(source_normal_valid, w_normal, torch.ones_like(w_normal))
        w = w * w_normal
    w = torch.where(mask, w, torch.zeros_like(w))
    valid_count = torch.sum(mask)
    w_mean = torch.sum(w) / torch.clamp(valid_count, min=1)
    w = w / torch.clamp(2.0 * w_mean, min=1e-12)
    J = torch.cat([_cross(cur, grad), grad], dim=-1)
    Jw = J * w[:, None]
    N = J.T @ Jw
    g = -(Jw.T @ residual)
    photo_n = torch.zeros((), dtype=torch.float32)
    res_cm = (torch.sum(torch.where(mask, torch.abs(residual), torch.zeros_like(residual)))
              / torch.clamp(valid_count, min=1) * 100.0)
    return torch.cat([N.reshape(-1), g, res_cm[None], valid_count.to(torch.float32)[None],
                      photo_n[None]])


@pytest.mark.parametrize("normals", [False, True], ids=["no_normals", "normals"])
@pytest.mark.parametrize("after_pgo", [False, True], ids=["before_pgo", "after_pgo"])
def test_twin_is_the_former_step_bit_for_bit(trained, after_pgo, normals):
    from pin_slam_torch.ops import track_kernel as tk

    s = trained["s"]
    cache, lm, nrm, nv, R, t = _step_inputs(trained, after_pgo, normals)
    args = (cache, lm, s.mc, s.decoder, s.sdf_scale, trained["src"], trained["src_valid"], R, t)
    with torch.no_grad():
        got = tk.track_step_plain(*args, s.tc, after_pgo, nrm, nv)
        ref = _former_step(cache, lm, s.mc, s.tc, s.decoder, s.sdf_scale, trained["src"],
                           trained["src_valid"], R, t, after_pgo, nrm, nv)
    assert got.shape == (tk.PACKED,)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert got[43] > 0.3 * trained["src_valid"].sum() and got[44] == 0


def test_padded_rows_add_exact_zeros(trained):
    """Whatever the padded source rows (source_valid False) hold, and
    whatever candidates their cache rows name, the packed vector keeps
    every bit."""
    from pin_slam_torch.ops import track_kernel as tk
    from pin_slam_torch.slam import tracker_grad as tg

    s = trained["s"]
    src, valid = trained["src"], trained["src_valid"]
    n = int(valid.sum())
    assert n < src.shape[0]
    junk = src.clone()
    junk[n:] = torch.as_tensor(np.random.default_rng(1).uniform(-30, 30, (src.shape[0] - n, 3)),
                               dtype=torch.float32)
    R, t = _pose()
    outs = []
    with torch.no_grad():
        for pts in (src, junk):
            cache = tg.probe_candidates(s.lm, s.mc, pts @ R.T + t + s.lm.origin, s.append_tmpl)
            outs.append(tk.track_step(cache, s.lm, s.mc, s.decoder, s.sdf_scale, pts, valid, R, t,
                                      None, s.tc))
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    assert outs[0][43] > 0


def test_cpu_wrapper_runs_the_twin_and_counts_no_launch(trained):
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import track_kernel as tk

    s = trained["s"]
    cache, lm, nrm, nv, R, t = _step_inputs(trained, False, True)
    before = _cuda.COUNTS["track_step"]
    with torch.no_grad():
        got = tk.track_step(cache, lm, s.mc, s.decoder, s.sdf_scale, trained["src"],
                            trained["src_valid"], R, t, lm.origin.clone(), s.tc, False, nrm, nv)
        twin = tk.track_step_plain(cache, lm, s.mc, s.decoder, s.sdf_scale, trained["src"],
                                   trained["src_valid"], R, t, s.tc, False, nrm, nv)
    assert _cuda.COUNTS["track_step"] == before
    assert torch.equal(got, twin)
    # what the kernel would refuse is refused here too
    with pytest.raises(ValueError):
        tk.track_step(cache, lm, s.mc, s.decoder, s.sdf_scale, trained["src"][:, [0, 2, 1]].t()
                      .contiguous().t(), trained["src_valid"], R, t, None, s.tc)


@pytest.mark.parametrize("widths,takes", [
    ((8, 64, 1, 6, 16), True), ((64, 256, 1, 16, 32), True), ((1, 1, 1, 1, 1), True),
    ((8, 64, 2, 6, 16), False), ((8, 512, 1, 6, 16), False), ((65, 64, 1, 6, 16), False),
    ((8, 257, 1, 6, 16), False), ((8, 64, 1, 17, 32), False), ((8, 64, 1, 6, 33), False),
    ((8, 64, 1, 6, 5), False), ((8, 64, 0, 6, 16), False)],
    ids=["default", "widest", "narrowest", "two_hidden", "H512", "F65", "H257", "k17", "M33",
         "M_below_k", "no_hidden"])
def test_track_kernel_takes(widths, takes):
    from pin_slam_torch.ops import track_kernel as tk

    assert tk.track_kernel_takes(*widths) is takes


def _route_counts(monkeypatch, trained, decoder=None, mc=None, lm=None, **kw):
    """Calls of the kernel's wrapper and of the torch step in one short
    ``track_frame`` (two iterations)."""
    from pin_slam_torch.ops import track_kernel as tk
    from pin_slam_torch.slam import tracker as trk

    s = trained["s"]
    calls = {"kernel": 0, "torch": 0}
    step, plain = tk.track_step, tk.track_step_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tk, "track_step", count("kernel", step))
    monkeypatch.setattr(tk, "track_step_plain", count("torch", plain))
    tc = dataclasses.replace(s.tc, reg_iter_n=2)
    R, t = _pose()
    trk.track_frame(lm or s.lm, mc or s.mc, tc, decoder or s.decoder, s.sdf_scale, s.append_tmpl,
                    trained["src"], trained["src_valid"], R, t, **kw)
    return calls


def test_route_follows_what_the_code_observes(monkeypatch, trained):
    """The cached step goes to the kernel's wrapper; a decoder of two hidden
    layers or of 512 units to the torch step; the encoded and colour paths
    reach neither (they keep their autograd steps)."""
    from pin_slam_torch.models.decoder import Decoder
    from pin_slam_torch.slam import tracker as trk

    s = trained["s"]
    F = s.mc.feature_dim
    assert trk.kernel_route(s.mc, s.decoder, 16)
    # on the CPU the kernel's wrapper runs the twin: both count
    assert _route_counts(monkeypatch, trained) == {"kernel": 3, "torch": 3}
    for level, H in ((2, 64), (1, 512)):
        # an untrained decoder: the gates may stop after the first step
        dec = Decoder(F + 3, H, level, 1, generator=torch.Generator().manual_seed(0))
        assert not trk.kernel_route(s.mc, dec, 16)
        calls = _route_counts(monkeypatch, trained, decoder=dec)
        assert calls["kernel"] == 0 and calls["torch"] >= 2

    def stub(*a):
        n = trained["src"].shape[0]
        g = torch.zeros((n, 3))
        g[:, 0] = 1.0
        return torch.zeros(n), g, torch.full((n,), 6), torch.zeros(n)

    monkeypatch.setattr(trk, "_autograd_sdf", lambda *a: stub())
    enc = dataclasses.replace(s.mc, pos_encoding_band=4)
    assert _route_counts(monkeypatch, trained, mc=enc) == {"kernel": 0, "torch": 0}
    sdf, g, nn, std = stub()
    monkeypatch.setattr(trk, "_sdf_intensity_grads",
                        lambda *a: (sdf, g, torch.zeros_like(sdf), g, nn, std))
    lm_c = dataclasses.replace(s.lm, color_features=torch.zeros_like(s.lm.geo_features))
    assert _route_counts(monkeypatch, trained, lm=lm_c, color_decoder=s.decoder,
                         source_colors=torch.zeros((trained["src"].shape[0], 3))) == \
        {"kernel": 0, "torch": 0}


def test_gn_kernel_share_reads_the_reports():
    from slambench import harness

    read = harness.metric_reader("gn_kernel_share")

    def report(launched, odometry, pgo=0):
        return {"trace": {"counts": {"sync.odometry.gn_fetch": odometry,
                                     "sync.pgo.gn_fetch": pgo, "sync.odometry.pose_R": 9},
                          "launches": {"track_step": launched} if launched else {}}}

    assert read(harness.RunRecord()) is None
    assert read(harness.RunRecord(infos=[{"reg_valid": True}])) is None
    assert read(harness.RunRecord(infos=[report(5, 5), report(9, 4, 5)])) == 1.0
    assert read(harness.RunRecord(infos=[report(0, 5), report(5, 5)])) == 0.5
    assert read(types.SimpleNamespace(infos=[report(0, 0)])) is None
