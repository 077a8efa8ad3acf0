"""The widths the port's CUDA training kernels take, on the CPU: the one
shape predicate ``train_kernel.kernels_take`` against
``mapper.kernel_path_supported`` on a grid of configurations (so the two
can never disagree), the tiled form's shared-memory layouts for every width
the predicate takes, the dispatch between the dedicated build, the width
classes and the tiled form, ``SlamSystem.kernel_path`` at wide feature and
hidden widths and at NeRF band 11, and the decoder carried across from the
JAX package at F = 16, H = 128."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import _config

from pin_slam_torch.ops import train_kernel as tk

torch.set_num_threads(1)


def _mapper_configs(over):
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam import mapper as tm

    cfg = _config(Config, over.pop("weighted_first", False))
    for key, v in over.items():
        setattr(cfg, key, v)
    cfg._derive()
    return tm.MapperConfig.from_config(cfg), cfg


GRID = list(itertools.product(
    (1, 4, 8, 16, 32, 64, 65, 128),                   # feature_dim
    (16, 64, 100, 128, 256, 257, 512),                # mlp_hidden_dim
    ((0, False), (4, False), (11, False), (32, False), (33, False),   # NeRF bands
     (16, True), (31, True), (96, True), (97, True)),                 # Gaussian bands
))


@pytest.mark.parametrize("k", [6, 8, 16, 17])
def test_kernels_take_is_kernel_path_supported(k, capsys):
    """On every (feature_dim, mlp_hidden_dim, encoding) of the grid at this
    query_nn_k, the kernel path is chosen exactly where kernels_take accepts
    the widths, and a refusal by width is logged."""
    from pin_slam_torch.slam import mapper as tm

    for F, H, (band, gauss) in GRID:
        mcfg, cfg = _mapper_configs(dict(feature_dim=F, geo_mlp_hidden_dim=H,
                                         pos_encoding_band=band, use_gaussian_pe=gauss,
                                         query_nn_k=k))
        take = tk.kernels_take(F, H, mcfg.vec_dim, mcfg.nn_k)
        assert tm.kernel_path_supported(mcfg, cfg) == take, (F, H, band, gauss, k)
        out = capsys.readouterr().out
        assert ("past the training kernels' widths" in out) == (not take)
        # the predicate's box: F <= 64, H <= 256, VD <= 195 (NeRF band 32), k <= 16
        assert take == (F <= 64 and H <= 256 and mcfg.vec_dim <= 195 and k <= 16)


def test_kernels_take_bounds():
    """The bound lies at F = 64, H = 256, VD = 195 (NeRF band 32) and k = 16,
    each taken together with the others at their widest."""
    assert tk.kernels_take(64, 256, 195, 16)
    for F, H, vd, k in ((65, 256, 195, 16), (64, 257, 195, 16), (64, 256, 196, 16),
                        (64, 256, 195, 17), (0, 64, 3, 6), (8, 0, 3, 6), (8, 64, 0, 6),
                        (8, 64, 3, 0)):
        assert not tk.kernels_take(F, H, vd, k)


@pytest.mark.parametrize("eikonal", [False, True], ids=["train", "eikonal"])
@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
def test_tiled_plan_fits_every_width_taken(wf, eikonal):
    """A layout fits the H100's block budget for every width kernels_take
    accepts (at the corners and between), a group holds at least one row's
    decodes, and the plan is the first of the stated order that fits."""
    for F, H, vd, k in itertools.product((1, 3, 8, 16, 33, 64), (1, 63, 64, 128, 200, 256),
                                         (1, 3, 27, 65, 69, 123, 195), (1, 6, 8, 16)):
        plan = tk.tiled_plan(F, H, vd, k, wf, eikonal)
        assert plan is not None, (F, H, vd, k)
        res, dc, dmax, floats = plan
        dr = (6 if eikonal else 1) * (1 if wf else k)
        assert dmax >= dr and dc in tk.TILED_DC and dmax in tk.TILED_DMAX
        assert floats <= tk.TILED_BUDGETS[-1]
    assert tk.tiled_plan(65, 64, 3, 6, wf, eikonal) is None
    assert tk.tiled_plan(8, 64, 3, 17, wf, eikonal) is None
    # the paths' widths: W1 resident, one chunk a group, two blocks an SM
    for F, H, vd in ((16, 128, 3), (8, 64, 69)):
        res, dc, dmax, floats = tk.tiled_plan(F, H, vd, 6, wf, eikonal)
        assert res == 1 and dc == dmax == 128 and floats <= tk.TILED_BUDGETS[0]
    # the widest streams W1 in slabs, in groups of several chunks when a row
    # has 96 decodes (eikonal, per neighbour, k = 16)
    res, dc, dmax, _ = tk.tiled_plan(64, 256, 195, 16, wf, eikonal)
    assert res == 0 and dc == 64 and dmax >= (96 if eikonal and not wf else 64)


def test_general_form_dispatch():
    """The dedicated build at exactly (8, 64, 3), the width classes at F = 8,
    H = 64 and VD up to 64, the tiled form at every other width; n_params
    and hidden_width read the widths off the packed decoder."""
    assert tk.general_form(8, 64, 3) == "dedicated"
    for vd in (1, 2, 4, 15, 27, 35, 64):
        assert tk.general_form(8, 64, vd) == "class"
    for F, H, vd in ((16, 64, 3), (8, 128, 3), (8, 64, 65), (4, 32, 27), (64, 256, 195)):
        assert tk.general_form(F, H, vd) == "tiled"
        n = tk.n_params(vd, F, H)
        assert n == (F + vd) * H + 2 * H + 1
        assert tk.hidden_width(n, F, vd) == H
    for n, F, vd in ((100, 8, 3), (1, 8, 3), (0, 8, 3)):
        with pytest.raises(ValueError):
            tk.hidden_width(n, F, vd)


def test_wrappers_take_the_widths_from_the_tensors():
    """On the CPU the wrappers run the plain twins at any width; a packed
    decoder that is no one-hidden-layer decoder of F + VD inputs is refused
    on the CPU as it would be on the card."""
    rng = np.random.default_rng(3)
    F, H, vd, B, k = 16, 128, 3, 5, 6
    feats = torch.as_tensor(rng.standard_normal((B, k, F + 1)).astype(np.float32))
    w = torch.full((B, k), 1.0 / k)
    vin = torch.as_tensor(rng.standard_normal((B, k * vd)).astype(np.float32))
    lab, wt = torch.zeros(B), torch.ones(B) / B
    params = torch.as_tensor(rng.standard_normal(tk.n_params(vd, F, H)).astype(np.float32))
    loss, dfeats, dparams = tk.train_iter(feats, w, vin, lab, wt, params, False, 0.05, 0.1)
    assert dfeats.shape == (B, k, F + 1) and dparams.shape == params.shape
    assert torch.isfinite(loss)
    with pytest.raises(ValueError):
        tk.train_iter(feats, w, vin, lab, wt, params[:-1], False, 0.05, 0.1)


@pytest.mark.parametrize("over", [
    dict(feature_dim=16, geo_mlp_hidden_dim=128),
    dict(pos_encoding_band=11, pos_encoding_freq=20)], ids=["f16_h128", "nerf11"])
def test_slam_system_takes_the_kernel_path(over):
    """SlamSystem chooses the training kernels at feature_dim 16 /
    mlp_hidden_dim 128 and at NeRF band 11 (VD 69), which the kernels raised
    on before; its decoder has those widths."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, False)
    for key, v in over.items():
        setattr(cfg, key, v)
    cfg._derive()
    system = SlamSystem(cfg, device="cpu")
    assert system.kernel_path
    lin = system.decoder.hidden[0]
    assert lin.in_features == cfg.feature_dim + system.mcfg.vec_dim
    assert lin.out_features == cfg.geo_mlp_hidden_dim
    assert tk.kernels_take(cfg.feature_dim, cfg.geo_mlp_hidden_dim, system.mcfg.vec_dim,
                           system.mcfg.nn_k)


def test_slam_system_past_the_widths_trains_by_autograd(capsys):
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem

    cfg = _config(Config, False)
    cfg.geo_mlp_hidden_dim = 320
    cfg._derive()
    system = SlamSystem(cfg, device="cpu")
    assert not system.kernel_path
    assert "training by mapping_loop_autograd" in capsys.readouterr().out


def test_decoder_carried_across_at_wide_widths():
    """params_from_jax / decoder_from_jax and the packed vector at F = 16,
    H = 128: the port's decoder gives the JAX decoder's outputs, and its
    packed vector is the JAX leaves in the kernels' layout, whose widths the
    wrappers read back."""
    from pin_slam_torch.models.decoder import decoder_from_jax, params_from_jax
    from pin_slam_tpu.models import decoder as jd

    F, H, vd = 16, 128, 3
    p = jd.init_decoder(jax.random.PRNGKey(4), F + vd, H, 1, 1)
    pn = jax.tree.map(np.asarray, p)
    state = params_from_jax(pn)
    assert state["hidden.0.weight"].shape == (H, F + vd)
    dec = decoder_from_jax(pn)
    x = np.random.default_rng(1).standard_normal((7, F + vd)).astype(np.float32)
    ref = np.asarray(jd._mlp(p, jnp.asarray(x)))
    with torch.no_grad():
        got = dec.out(torch.relu(dec.hidden[0](torch.as_tensor(x)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    (W1, b1), (W2, b2) = pn.hidden[0], pn.out
    packed = dec.pack()
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(
        [W1.ravel(), b1, W2.ravel(), b2]).astype(np.float32))
    assert tk.hidden_width(packed.shape[0], F, vd) == H
