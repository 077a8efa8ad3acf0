"""Configurations beyond the default, through the port's SlamSystem
against the JAX package's on the tiny synthetic corridor of
tests/test_torch_pipeline.py, frame by frame from synced state (the same
harness and the same pose tolerances: 2 cm / 0.2 deg):

* livox-like: per-neighbour decoding at k = 8 (``run_livox.yaml``'s
  ``query_nn_k``).  The JAX package's cached pool holds k = 6 only (ROADMAP
  C 2), so both packages train by their exact-kNN loops
  (``PIN_SLAM_EXACT_KNN=1``), which re-query the kNN at k = 8;
* NeRF positional encoding (4 bands, VD = 27), per neighbour, cached, at
  ``pos_encoding_freq`` 20 (at the default 200 the ladder reaches 100
  cycles a metre, and on this tiny scene neither package registers);
* Gaussian Fourier features (16 bands, VD = 35), weighted_first, cached,
  at ``pos_encoding_freq`` 1 (a projection of N(0, 1) cycles a metre; at
  the default 200 neither package registers a frame on this scene, and at
  2 both register but their trackers part by ~1 cm);
* exact kNN with feature layer-norm, per neighbour.  Two reference faults
  are shimmed on the JAX side for the comparison (ROADMAP C 16): the JAX
  layer-norm's gradient is NaN on a row of equal values (a new point's zero
  features), so ``jnp.std`` gets the zero gradient ``torch.std`` has there;
  and the JAX tracker's closed-form path reads raw features under
  ``layer_norm_on``, so its cores get the normalised rows the port reads.

* wider decoders on the training kernels' tiled form: ``feature_dim`` 16
  with ``mlp_hidden_dim`` 128, per neighbour; and NeRF band 11 (VD = 69,
  the first offset width past the width classes), per neighbour, at
  ``pos_encoding_freq`` 20.

Each runs 3 frames.  With k = 8 the JAX package's pool rows are k = 6
wide: the sync carries the samples' columns (all its exact loop reads) into
the port's wider rows."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import JaxDraws, _config, _frames, _sync_from_jax

torch.set_num_threads(2)

CONFIGS = {
    "livox_k8_exact": (dict(weighted_first=False, query_nn_k=8), True),
    "nerf4_per_neighbor": (dict(weighted_first=False, pos_encoding_band=4,
                                pos_encoding_freq=20), False),
    "gauss16_wf": (dict(weighted_first=True, pos_encoding_band=16, use_gaussian_pe=True,
                        pos_encoding_freq=1), False),
    "exact_layer_norm": (dict(weighted_first=False, layer_norm_on=True), True),
    "wide_f16_h128": (dict(weighted_first=False, feature_dim=16, geo_mlp_hidden_dim=128), False),
    "nerf11_per_neighbor": (dict(weighted_first=False, pos_encoding_band=11,
                                 pos_encoding_freq=20), False),
}


def _cfg(Config, over):
    cfg = _config(Config, over["weighted_first"])
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg._derive()
    return cfg


def _sync(tsys, jsys):
    """The harness's sync; the JAX pool's sample columns laid into the port's
    rows where the layouts differ (k = 8)."""
    from pin_slam_torch.slam import mapper as tm

    _sync_from_jax(tsys, jsys)
    rows = tsys.pool.rows
    if rows.shape[1] != tsys.mcfg.pool_dim:
        out = torch.zeros((rows.shape[0], tsys.mcfg.pool_dim))
        out[:, :tm.P_KNN.start] = rows[:, :tm.P_KNN.start]
        out[:, tsys.mcfg.p_knn] = -1.0
        tsys.pool.rows = out


@jax.custom_jvp
def _safe_std(x):
    return jnp.std(x, axis=-1, keepdims=True)


@_safe_std.defjvp
def _safe_std_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    s = _safe_std(x)
    n = x.shape[-1]
    pos = s > 0
    ds = (jnp.sum((x - jnp.mean(x, -1, keepdims=True)) * dx, -1, keepdims=True)
          / (n * jnp.where(pos, s, 1.0)))
    return s, jnp.where(pos, ds, 0.0)


def _shim_jax_layer_norm(monkeypatch):
    """ROADMAP C 16 on the JAX side: a zero std gradient where the std is 0,
    and the tracker's closed form reading normalised feature rows."""
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import tracker_grad as jtg

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.std = lambda x, axis=-1, keepdims=False: _safe_std(x)
    monkeypatch.setattr(jn, "jnp", proxy)

    def normed(core):
        def f(mc, geo, scale, pts, nbr, quat, feats, valid, after_pgo):
            fr = jnp.where(valid[..., None], feats, 0.0)
            mu = jnp.mean(fr, -1, keepdims=True)
            fr = (fr - mu) / (_safe_std(fr) + 1e-6)
            return core(mc, geo, scale, pts, nbr, quat, fr, valid, after_pgo)
        return f

    monkeypatch.setattr(jtg, "_core", normed(jtg._core))
    monkeypatch.setattr(jtg, "_core_pn", normed(jtg._core_pn))


def _track_frame_matches(tsys, jsys, arr, valid):
    """track_frame with positional encoding from the synced state: the
    port's autograd path (a fresh kNN and one autograd.grad an evaluation)
    against the JAX package's jax.vjp path on the same source cloud: the
    same validity and stop decision, iterations within 2 (the steps near
    convergence are at the rounding-noise level, tests/test_torch_tracker.py),
    the residual within 1 %.  On this scene neither package meets the stop
    thresholds within the 50 iterations: the last steps go back and forth by
    millimetres, so the poses agree within 5 mm / 5e-3 rad."""
    from pin_slam_torch.slam import tracker as ttr
    from pin_slam_tpu.slam import tracker as jtr

    src, src_valid = tsys._source_prep(torch.as_tensor(arr), torch.as_tensor(valid))
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jres = jtr.track_frame(jsys.lm, jsys.mc, jsys.tc, jsys.geo_params, jsys.sdf_scale,
                           jsys.append_tmpl, jnp.asarray(src.numpy()),
                           jnp.asarray(src_valid.numpy()), jnp.asarray(R0), jnp.asarray(t0))
    tres = ttr.track_frame(tsys.lm, tsys.mc, tsys.tc, tsys.decoder, tsys.sdf_scale,
                           tsys.append_tmpl, src, src_valid, R0, t0)
    assert tres.valid == bool(jres.valid) and tres.converged == bool(jres.converged)
    assert abs(tres.iterations - int(jres.iterations)) <= 2
    np.testing.assert_allclose(tres.sdf_residual_cm, float(jres.sdf_residual_cm), rtol=1e-2)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=5e-3)
    np.testing.assert_allclose(tres.R.numpy(), np.asarray(jres.R), atol=5e-3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configuration_matches_jax(name, monkeypatch):
    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.dataset.slam_dataset import Frame as TFrame
    from pin_slam_torch.slam.pipeline import SlamSystem as TSlam
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.dataset.slam_dataset import Frame as JFrame
    from pin_slam_tpu.slam.pipeline import SlamSystem as JSlam

    over, exact = CONFIGS[name]
    monkeypatch.setenv("PIN_SLAM_EXACT_KNN", "1" if exact else "0")
    if over.get("layer_norm_on"):
        _shim_jax_layer_norm(monkeypatch)
    jsys = JSlam(_cfg(JConfig, over))
    jsys.tc = dataclasses.replace(jsys.tc, min_valid_ratio=0.1)
    tcfg = _cfg(TConfig, over)
    tsys = TSlam(tcfg, device="cpu", random_source=JaxDraws(tcfg.seed, jsys.mcfg))
    tsys.tc = dataclasses.replace(tsys.tc, min_valid_ratio=0.1)
    assert tsys.exact_knn == exact and tsys.kernel_path == (not exact)
    assert tsys.decoder.hidden[0].in_features == tcfg.feature_dim + jsys.mcfg.vec_dim
    assert tsys.decoder.hidden[0].out_features == tcfg.geo_mlp_hidden_dim
    if not exact:
        assert tsys.mcfg.pool_dim == jsys.mcfg.pool_dim

    registered = []
    for i, (arr, valid, n) in enumerate(_frames(3)):
        _sync(tsys, jsys)
        if i == 1 and over.get("pos_encoding_band"):
            _track_frame_matches(tsys, jsys, arr, valid)
        j_info = jsys.process_frame(JFrame(arr, valid, None, None, None, n))
        t_info = tsys.process_frame(TFrame(arr, valid, n))
        if i > 0:
            assert bool(j_info["reg_valid"]) == t_info["reg_valid"], (i, j_info, t_info)
            registered.append(t_info["reg_valid"])
        if "loss_last" in t_info:
            assert np.isfinite(t_info["loss_last"])
        Tj, Tt = jsys.cur_pose, tsys.cur_pose
        assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 0.02, (i, Tj[:3, 3], Tt[:3, 3])
        cos = (np.trace(Tj[:3, :3].T @ Tt[:3, :3]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2, i
        for a, b in ((int(tsys.state.count), int(jsys.state.count)),
                     (int(tsys.pool.fill), int(jsys.pool.fill))):
            assert abs(a - b) <= 0.05 * b, (i, a, b)
    assert all(registered), registered


@pytest.mark.parametrize("over, exact", [
    (dict(pos_encoding_band=4), False), (dict(pos_encoding_band=16, use_gaussian_pe=True), False),
    (dict(query_nn_k=8), False), (dict(), True), (dict(layer_norm_on=True), True),
    (dict(color_on=True, semantic_on=True), True), (dict(color_on=True, geo_mlp_level=2), True),
    (dict(color_on=True, semantic_on=True), False), (dict(color_on=True, geo_mlp_level=2), False)],
    ids=["nerf", "gaussian", "k8", "exact", "exact_layer_norm", "exact_colour_semantic",
         "exact_colour_deep_decoder", "colour_semantic", "colour_deep_decoder"])
def test_lifted_refusals_pass_check_ported(over, exact, monkeypatch):
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import check_ported

    monkeypatch.setenv("PIN_SLAM_EXACT_KNN", "1" if exact else "0")
    cfg = _config(Config, True)
    for k, v in over.items():
        setattr(cfg, k, v)
    check_ported(cfg)


@pytest.mark.parametrize("over, label", [
    (dict(layer_norm_on=True), "C 14"),
    (dict(layer_norm_on=True, color_on=True, semantic_on=True), "C 14")])
def test_cached_path_still_refuses(over, label, monkeypatch):
    """Without PIN_SLAM_EXACT_KNN=1 the cached loop would train raw features
    under layer-norm (the JAX package's C 14), with or without the other
    heads: the refusal names the ROADMAP item and the variable."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import check_ported

    monkeypatch.delenv("PIN_SLAM_EXACT_KNN", raising=False)
    cfg = _config(Config, True)
    for k, v in over.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match=label) as e:
        check_ported(cfg)
    assert "PIN_SLAM_EXACT_KNN=1" in str(e.value)
