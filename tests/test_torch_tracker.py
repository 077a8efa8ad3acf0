"""The port's tracker (candidate probe, cached SDF + analytic gradient,
track_frame with every health gate) against the JAX package's on the same
trained map, in both interpolation modes.  The map is trained by the port on
frame 0 of the synthetic corridor scene and handed to JAX as arrays.

Tolerances: candidate sets exact; SDF values / gradients rtol 1e-4 /
atol 1e-5 (float32, matmul order differs); the registered pose within
1e-3 m / 1e-3 rad (a few dozen Gauss-Newton steps compound the rounding)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[True, False], ids=["wf", "per_neighbor"])
def trained(request):
    from pin_slam_torch.config import Config
    from pin_slam_torch.dataset.slam_dataset import Frame
    from pin_slam_torch.ops.voxel import pad_to
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn

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
    lm = s.lm
    jmc = jn.MapConfig.from_config(cfg)
    jlm = jn.LocalMap(indices=jnp.asarray(np_(lm.indices).astype(np.int32)),
                      attr_rows=jnp.asarray(np_(lm.attr_rows)),
                      geo_features=jnp.asarray(np_(lm.geo_features)), color_features=None,
                      count=jnp.int32(int(lm.count)), member_mask=jnp.asarray(np_(lm.member_mask)),
                      lo1=jnp.int32(int(lm.lo1)), lo2=jnp.int32(int(lm.lo2)),
                      origin=jnp.asarray(np_(lm.origin)), hash_rows=jnp.asarray(np_(lm.hash_rows)))
    (W1, b1), (W2, b2) = ((np_(W).copy(), np_(b).copy()) for W, b in s.decoder.layers())
    jgeo = jdec.DecoderParams(hidden=((jnp.asarray(W1), jnp.asarray(b1)),),
                              out=(jnp.asarray(W2), jnp.asarray(b2)))
    src, src_valid = s._source_prep(torch.as_tensor(frames[1][0]), torch.as_tensor(frames[1][1]))
    return dict(s=s, jmc=jmc, jlm=jlm, jgeo=jgeo, src=src, src_valid=src_valid, cfg=cfg)


def test_cached_sdf_and_grad_match(trained):
    from pin_slam_torch.slam import tracker_grad as ttg
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import tracker_grad as jtg

    s, cfg = trained["s"], trained["cfg"]
    pts = trained["src"] + torch.tensor([0.08, 0.02, 0.0])     # near the true pose
    jt = jn.make_probe_template(trained["jmc"], cfg.num_nei_cells, cfg.search_alpha)
    jc = jax.jit(jtg.probe_candidates, static_argnums=1)(trained["jlm"], trained["jmc"],
                                                         jnp.asarray(np_(pts)), jt)
    tc = ttg.probe_candidates(s.lm, s.mc, pts, s.append_tmpl)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np_(a), np_(b))
    q = pts + 0.03
    jr = jax.jit(jtg.sdf_value_and_grad_cached, static_argnums=(2, 4))(
        jc, trained["jlm"], trained["jmc"], trained["jgeo"], s.sdf_scale, jnp.asarray(np_(q)))
    tr = ttg.sdf_value_and_grad_cached(tc, s.lm, s.mc, s.decoder, s.sdf_scale, q)
    np.testing.assert_array_equal(np_(tr[2]), np_(jr[2]))            # nn_count
    for a, b in ((tr[0], jr[0]), (tr[1], jr[1]), (tr[3], jr[3])):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-4, atol=1e-5)
    assert (np_(tr[2]) >= 6).mean() > 0.3


def test_track_frame_matches(trained):
    from pin_slam_torch.slam import tracker as ttr
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import tracker as jtr

    s, cfg = trained["s"], trained["cfg"]
    tc = dataclasses.replace(s.tc, min_valid_ratio=0.1)
    jtc = dataclasses.replace(jtr.TrackerConfig.from_config(cfg), min_valid_ratio=0.1)
    jt = jn.make_probe_template(trained["jmc"], cfg.num_nei_cells, cfg.search_alpha)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jres = jtr.track_frame(trained["jlm"], trained["jmc"], jtc, trained["jgeo"], s.sdf_scale, jt,
                           jnp.asarray(np_(trained["src"])), jnp.asarray(np_(trained["src_valid"])),
                           jnp.asarray(R0), jnp.asarray(t0))
    tres = ttr.track_frame(s.lm, s.mc, tc, s.decoder, s.sdf_scale, s.append_tmpl,
                           trained["src"], trained["src_valid"], R0, t0)
    assert bool(jres.valid) and tres.valid
    assert tres.converged == bool(jres.converged)
    # the step sizes near convergence are at the rounding-noise level, so the
    # iteration that first falls under the 0.01 deg / 0.5 mm thresholds varies
    assert tres.iterations > 1 and int(jres.iterations) > 1
    assert abs(tres.valid_count - int(jres.valid_count)) <= 0.01 * int(jres.valid_count)
    np.testing.assert_allclose(np_(tres.t), np_(jres.t), atol=1e-3)
    np.testing.assert_allclose(np_(tres.R), np_(jres.R), atol=1e-3)
    np.testing.assert_allclose(tres.sdf_residual_cm, float(jres.sdf_residual_cm), rtol=1e-2)
    # and it registered the true motion (frame 1 of the scene: +0.1 m in x)
    assert abs(float(tres.t[0]) - 0.1) < 0.05
