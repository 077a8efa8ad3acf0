"""The port's sliding-window bundle adjustment (pin_slam_torch.slam.mapper
.bundle_adjustment_loop and SlamSystem._bundle_adjustment) against the JAX
package's, on the map, pool and decoder a few frames of the JAX SlamSystem
leave on a tiny synthetic scene, in both interpolation modes.

The JAX package's draws are injected.  Whole loops are compared loosely and
gradients strictly: Adam with eps 1e-15 turns rounding into sign flips of
near-zero gradient entries (ROADMAP C 7), so the strict comparison is made
iteration by iteration from synced state.  The deterministic-gradient design
is checked too: the feature gather's backward has the in-order scatter's
bits, and no indexed backward (which adds with float atomics on the card)
is in the loss's autograd graph."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_pipeline import JaxDraws, _config, _frames, _sync_from_jax
from torch_port_util import np_

torch.set_num_threads(1)
BA_FRAME = 4          # BA at frame 3 with a window of 3 poses (frame 0 fixed)


def _configs(Config, wf, ba=True):
    cfg = _config(Config, wf)
    if ba:
        cfg.ba_freq_frame, cfg.ba_frame = BA_FRAME, BA_FRAME
    cfg._derive()
    return cfg


@pytest.fixture(scope="module", params=[True, False], ids=["wf", "per_neighbor"])
def jax_state(request):
    """A JAX SlamSystem after four frames (BA off), and the BA inputs of a
    window over its last three poses."""
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import Frame as JFrame
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    wf = request.param
    jsys = JSlam(_configs(JConfig, wf, ba=False))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    for arr, valid, n in _frames(4):
        jsys.process_frame(JFrame(arr, valid, None, None, None, n))
    poses = np.stack(jsys.dataset.odom_poses)
    window = 3
    poses_full = np.tile(np.eye(4, dtype=np.float32), (1 << 16, 1, 1))
    poses_full[:len(poses)] = poses.astype(np.float32)
    return dict(jsys=jsys, wf=wf, window=window, window_start=len(poses) - window,
                poses_full=poses_full)


def _port_inputs(js):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import decoder_from_jax
    from pin_slam_torch.slam import mapper as tm

    jsys = js["jsys"]
    tcfg = _configs(TConfig, js["wf"], ba=False)
    return dict(
        lm=tn.local_map_from_numpy(jsys.lm), mc=tn.MapConfig.from_config(tcfg),
        mcfg=tm.MapperConfig.from_config(tcfg), pool=tm.pool_from_numpy(jsys.pool),
        decoder=decoder_from_jax(jax.tree.map(np.asarray, jsys.geo_params)).requires_grad_(False),
        offsets=torch.as_tensor(np.array(jsys.offsets)),
        feats=torch.as_tensor(np.array(jsys.lm.geo_features)),
        poses_full=torch.as_tensor(js["poses_full"]))


def _jax_draws(jsys, key, num_iters):
    keys = jax.random.split(key, num_iters)
    fill = jnp.maximum(jsys.pool.fill, 1)
    return np.stack([np.asarray(jax.random.randint(k, (jsys.mcfg.bs,), 0, fill))
                     for k in keys]).astype(np.int64)


def _jax_value_and_grad(js):
    """The JAX package's BA loss (``bundle_adjustment_loop``'s ``loss_fn``,
    built from its own ``_query_sdf`` and ``se3_expmap``) and its gradient
    in the features and xi, at given (features, xi, batch)."""
    from pin_slam_tpu.ops.transforms import se3_expmap
    from pin_slam_tpu.slam import mapper as jmp

    jsys = js["jsys"]
    lm, mc, mcfg, pool, offsets = jsys.lm, jsys.mc, jsys.mcfg, jsys.pool, jsys.offsets
    poses_full = jnp.asarray(js["poses_full"])
    ws, window = js["window_start"], js["window"]

    @jax.jit
    def vg(feats, xi, idx):
        surface = jnp.abs(pool.sdf_label) < 1e-6
        valid = (idx < pool.fill) & surface[idx] & (pool.rows[idx, jmp.P_TS] >= 0.0)
        local, ts = pool.local_coord[idx], pool.ts[idx]

        def loss_fn(f, x):
            T_base = poses_full[ts]
            in_win = ts >= ws
            widx = jnp.clip(ts - ws, 0, window - 1)
            dT = se3_expmap(x)[widx]
            eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), dT.shape)
            dT = jnp.where(in_win[:, None, None], dT, eye)
            T = jnp.einsum("nij,njk->nik", dT, T_base)
            coord = jnp.einsum("nij,nj->ni", T[:, :3, :3], local) + T[:, :3, 3]
            params = jmp.TrainableParams(features=f, color_features=None, geo=jsys.geo_params,
                                         sem=None, color=None)
            sdf_pred, _, _, _ = jmp._query_sdf(lm, mc, mcfg, offsets, coord, params,
                                               jnp.ones((), bool))
            per = jnp.where(valid, sdf_pred ** 2, 0.0)
            return jnp.sum(per) / jnp.maximum(jnp.sum(valid), 1)

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(feats, xi)

    return vg


def _batch(pool, idx):
    from pin_slam_torch.slam import mapper as tm

    rows = pool.rows[idx]
    surface = torch.abs(rows[:, tm.P_LABEL]) < 1e-6
    valid = (idx < pool.fill) & surface & (rows[:, tm.P_TS] >= 0.0)
    return rows[:, tm.P_LOCAL], rows[:, tm.P_TS].to(torch.int64), valid


def test_ba_gradients_match_jax_iteration_by_iteration(jax_state):
    """At every iteration of the port's loop, from the port's own state, the
    loss and the feature / xi gradients equal the JAX package's at the same
    state and batch: loss within 1e-5 relative, gradients within 1e-4 of
    their largest entry."""
    from pin_slam_torch.slam import mapper as tm

    js, p = jax_state, _port_inputs(jax_state)
    jsys = js["jsys"]
    T = 12
    idx = _jax_draws(jsys, jax.random.PRNGKey(3), T)
    vg = _jax_value_and_grad(js)
    feats, xi = p["feats"].clone(), torch.zeros((js["window"], 6))
    opt_f = tm.OptaxAdam(feats, p["mcfg"].lr, p["mcfg"].adam_eps)
    opt_x = tm.OptaxAdam(xi, p["mcfg"].lr, p["mcfg"].adam_eps)
    L = p["mc"].local_capacity
    for t in range(T):
        it = torch.as_tensor(idx[t])
        local, ts, valid = _batch(p["pool"], it)
        assert int(valid.sum()) > 100
        loss, g_f, g_x = tm.ba_value_and_grad(
            p["lm"], p["mc"], p["mcfg"], p["offsets"], p["decoder"], feats, xi,
            p["poses_full"], js["window_start"], local, ts, valid)
        jl, (jg_f, jg_x) = vg(jnp.asarray(np_(feats)), jnp.asarray(np_(xi)),
                              jnp.asarray(idx[t].astype(np.int32)))
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), (t, float(loss), float(jl))
        for a, b, what in ((g_f, jg_f, "features"), (g_x, jg_x, "xi")):
            b = np.asarray(b)
            scale = np.abs(b).max()
            assert scale > 0, (t, what)
            assert np.abs(np_(a) - b).max() <= 1e-4 * scale, (t, what)
        feats = feats + opt_f.update(g_f)
        feats[L] = 0.0
        xi = xi + 0.1 * opt_x.update(g_x)


def test_ba_loop_matches_jax(jax_state):
    """The whole loop with the JAX package's draws: the same first loss to
    1e-5, loss histories within 1e-3 relative, features and xi close, the
    sentinel row zero, the decoder untouched."""
    from pin_slam_torch.slam import mapper as tm
    from pin_slam_tpu.slam import mapper as jmp

    js, p = jax_state, _port_inputs(jax_state)
    jsys = js["jsys"]
    T, key = 12, jax.random.PRNGKey(5)
    params = jmp.TrainableParams(features=jsys.lm.geo_features, color_features=None,
                                 geo=jsys.geo_params, sem=None, color=None)
    j_params, j_xi, j_loss = jmp.bundle_adjustment_loop(
        jsys.lm, jsys.mc, params, jsys.pool, jsys.mcfg, jsys.offsets,
        jnp.asarray(js["poses_full"]), jnp.int32(js["window_start"]),
        jnp.zeros((js["window"], 6), jnp.float32), key, num_iters=T, window=js["window"])
    dec_before = [t.clone() for t in p["decoder"].parameters()]
    feats, xi, loss = tm.bundle_adjustment_loop(
        p["lm"], p["mc"], p["feats"], p["decoder"], p["pool"], p["mcfg"], p["offsets"],
        p["poses_full"], js["window_start"], torch.zeros((js["window"], 6)),
        torch.as_tensor(_jax_draws(jsys, key, T)))
    j_loss = np.asarray(j_loss)
    assert abs(float(loss[0]) - j_loss[0]) <= 1e-5 * j_loss[0]
    np.testing.assert_allclose(np_(loss), j_loss, rtol=1e-3)
    np.testing.assert_allclose(np_(xi), np.asarray(j_xi), atol=1e-4)
    jf = np.asarray(j_params.features)
    assert np.abs(np_(feats) - jf).max() <= 1e-3 * np.abs(jf).max()
    assert not feats[p["mc"].local_capacity].any()
    assert all(torch.equal(a, b) for a, b in zip(dec_before, p["decoder"].parameters()))


def test_gather_fn_backward_is_the_in_order_scatter():
    """rows.GatherRowsFn: forward table[idx]; backward bit-equal to
    rows.scatter_add_rows_ordered of the output gradient onto zeros, with
    the skipped row zero."""
    from pin_slam_torch.ops import rows

    g = torch.Generator().manual_seed(4)
    N, F = 257, 8
    table = torch.randn(N, F, generator=g)
    idx = torch.randint(0, N, (300, 6), generator=g)
    idx[torch.rand(300, 6, generator=g) < 0.2] = N - 1
    idx[:, 0] = 5                                  # one long segment
    w = torch.randn(300, 6, F, generator=g)
    tab = table.clone().requires_grad_(True)
    out = rows.GatherRowsFn.apply(tab, idx, N - 1)
    assert torch.equal(out, table[idx])
    (out * w).sum().backward()
    ref = rows.scatter_add_rows_ordered(torch.zeros(N, F), idx.reshape(-1),
                                        w.reshape(-1, F), N - 1)
    assert torch.equal(tab.grad.view(torch.int32), ref.view(torch.int32))
    assert not tab.grad[N - 1].any()


def _graph_names(fn):
    seen, stack, names = set(), [fn], set()
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack.extend(n for n, _ in f.next_functions)
    return names


def test_ba_graph_has_no_atomic_backward(jax_state, monkeypatch):
    """The loss's autograd graph holds the row kernels' Function and no
    indexed gather / index_put backward (those add with float atomics on
    the card)."""
    from pin_slam_torch.slam import mapper as tm

    js, p = jax_state, _port_inputs(jax_state)
    seen = []
    real = torch.autograd.grad

    def spy(outputs, inputs, *a, **kw):
        seen.append(_graph_names(outputs.grad_fn))
        return real(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    idx = torch.as_tensor(_jax_draws(js["jsys"], jax.random.PRNGKey(7), 1)[0])
    local, ts, valid = _batch(p["pool"], idx)
    tm.ba_value_and_grad(p["lm"], p["mc"], p["mcfg"], p["offsets"], p["decoder"], p["feats"],
                         torch.zeros((js["window"], 6)), p["poses_full"], js["window_start"],
                         local, ts, valid)
    (names,) = seen
    assert "GatherRowsFnBackward" in names, names
    bad = {n for n in names if n.startswith(("Index", "Gather", "Scatter", "Embedding",
                                             "Take", "Put"))} - {"GatherRowsFnBackward"}
    assert not bad, bad


class BaJaxDraws(JaxDraws):
    """The JAX SlamSystem's draws for a frame that may run BA: set ``key``
    to the JAX system's key before each frame; BA splits it first (the JAX
    pipeline's ``self.key, k_ba = split(self.key)``), then the frame's
    three-way split follows as usual."""

    def __init__(self, seed, jmcfg):
        super().__init__(seed, jmcfg)
        self.key = None

    def _frame_keys(self, fid):
        _, k_frame, k_train = jax.random.split(self.key, 3)
        return k_frame, k_train

    def ba_indices(self, fid, pool, bs, num_iters):
        self.key, k_ba = jax.random.split(self.key)
        keys = jax.random.split(k_ba, num_iters)
        fill = max(int(pool.fill), 1)
        return torch.as_tensor(np.stack([np.asarray(jax.random.randint(k, (bs,), 0, fill))
                                         for k in keys]), dtype=torch.int64)


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_slam_system_ba_frame_matches_jax(wf):
    """SlamSystem through a BA frame (ba_freq_frame 4, ba_frame 4: BA at
    frame 3, window 3) against the JAX package's, from synced state before
    every frame: each frame's pose, and after the BA frame every pose of the
    books, within 1e-4 m."""
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import Frame as TFrame
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import Frame as JFrame
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    jsys = JSlam(_configs(JConfig, wf))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    tcfg = _configs(TConfig, wf)
    draws = BaJaxDraws(tcfg.seed, jsys.mcfg)
    tsys = TSlam(tcfg, device="cpu", random_source=draws)
    tsys.tc = dataclasses.replace(tsys.tc, min_valid_ratio=0.1)
    ba_frames = []
    for i, (arr, valid, n) in enumerate(_frames(4)):
        _sync_from_jax(tsys, jsys)
        draws.key = jsys.key
        j_info = jsys.process_frame(JFrame(arr, valid, None, None, None, n))
        t_info = tsys.process_frame(TFrame(arr, valid, n))
        if "ba" in t_info:
            ba_frames.append(i)
            assert t_info["ba"]["window"] == 3 and t_info["ba"]["loss_finite"]
            assert t_info["ba"]["loss_last"] <= t_info["ba"]["loss_first"]
            jp, tp = np.stack(jsys.dataset.odom_poses), np.stack(tsys.dataset.odom_poses)
            assert np.abs(jp[:, :3, 3] - tp[:, :3, 3]).max() < 1e-4
            assert np.abs(jp[:, :3, :3] - tp[:, :3, :3]).max() < 1e-4
        assert np.linalg.norm(jsys.cur_pose[:3, 3] - tsys.cur_pose[:3, 3]) < 1e-4, i
    assert ba_frames == [3]


@pytest.mark.slow
def test_ba_reduces_pose_error(rng):
    """The JAX package's tests/test_bundle_adjustment.py gates on the port:
    a map trained on a box (by the JAX package, copied over), a pool of
    exact surface samples from 4 frames observed at the identity but booked
    with perturbed poses; 60 BA iterations must halve the loss and move the
    corrected poses toward the truth."""
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.models.decoder import decoder_from_jax
    from pin_slam_torch.ops.transforms import se3_expmap
    from pin_slam_torch.slam import mapper as tm
    from tests.test_mapping import build_and_train, ray_box_endpoints

    jmc, _, _, jlm, params, offsets, _, _ = build_and_train(rng, n_rays=8192, iters=400,
                                                             bs=8192)
    mc = tn.MapConfig(**{f.name: getattr(jmc, f.name) for f in dataclasses.fields(tn.MapConfig)
                         if hasattr(jmc, f.name)})
    lm = tn.local_map_from_numpy(jlm)
    decoder = decoder_from_jax(jax.tree.map(np.asarray, params.geo)).requires_grad_(False)
    n_frames, n_per, P = 4, 2048, 1 << 15
    mcfg = tm.MapperConfig(
        pool_capacity=P, new_idx_capacity=1 << 10, bs=4096, bs_new_sample=0, iters=1,
        lr=0.01, adam_eps=1e-15, sigma_sigmoid=0.1, sdf_scale=0.055, loss_weight_on=False,
        ekional_loss_on=False, weight_e=0.5, gradient_decimation=10, num_grad_step=0.06,
        surface_sample_range=0.25)
    pool = tm.init_pool(mcfg)
    pert_xi = (rng.normal(size=(n_frames, 6)) * [0.01, 0.01, 0.01, 0.05, 0.05, 0.05]
               ).astype(np.float32)
    poses_full = torch.eye(4).repeat(64, 1, 1)
    poses_full[:n_frames] = se3_expmap(torch.as_tensor(pert_xi))
    k = 6
    for f in range(n_frames):
        world = torch.as_tensor(ray_box_endpoints(rng, n_per))
        pool = tm.pool_append(pool, mcfg, world, world, torch.zeros(n_per), torch.ones(n_per),
                              torch.ones(n_per, dtype=torch.bool), f,
                              torch.zeros(n_per, dtype=torch.bool),
                              torch.full((n_per, k), -1, dtype=torch.int32),
                              torch.zeros(n_per, k), torch.zeros(n_per, 3))
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, int(pool.fill), (60, mcfg.bs), generator=g)
    _, xi, losses = tm.bundle_adjustment_loop(
        lm, mc, lm.geo_features, decoder, pool, mcfg,
        torch.as_tensor(np.asarray(offsets)), poses_full, 0,
        torch.zeros((n_frames, 6)), idx)
    assert float(losses[-1]) < float(losses[0]) * 0.5, (losses[0], losses[-1])
    dT = se3_expmap(xi).double()
    pf = poses_full[:n_frames].double()
    before = torch.linalg.norm(pf[:, :3, 3], dim=1).mean()
    after = torch.linalg.norm((dT @ pf)[:, :3, 3], dim=1).mean()
    assert after < before * 0.98, (before, after)
    assert torch.isfinite(xi).all()
