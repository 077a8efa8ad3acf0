"""The port's offline mesher (``python -m pin_slam_torch.vis_pin_map``)
against the repository's ``vis_pin_map.py`` on the CPU: one map (a slab of
neural points with features and a decoder drawn from a seed, with a colour
head) saved by each package, meshed by both scripts at 0.3 m.  Both build
the same map constants and query the same function, so the meshes agree:
the same vertex count within 1 %, every vertex within 1e-3 m of the other
mesh (both ways), the same face count within 1 %; each writes its PLY and a
``viewer.html``.  A crop cloud limits both to the same points."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import small_config

from pin_slam_torch.dataset import io as tio
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.models.decoder import decoder_from_jax
from pin_slam_torch.utils import experiment as texp
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.utils import experiment as jexp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    over = dict(map_capacity=1 << 13, local_map_capacity=1 << 11, buffer_size=1 << 15,
                downsample_hash_size=1 << 15, color_on=True, color_map_on=True)
    jmc = jn.MapConfig.from_config(small_config(JConfig, **over))
    rng = np.random.default_rng(7)
    js = jn.init_map_state(jmc)
    pts = np.column_stack([rng.uniform(-4, 4, 5000), rng.uniform(-3, 3, 5000),
                           rng.uniform(-0.6, 0.6, 5000)]).astype(np.float32)
    js = jn.map_insert(js, jmc, jnp.asarray(pts), jnp.ones(5000, bool), jnp.int32(0),
                       jnp.zeros((64,), jnp.float32), downsample_table_size=1 << 15)
    n = int(js.count)
    feats = np.asarray(js.geo_features).copy()
    feats[:n] = rng.normal(size=(n, feats.shape[1]))
    cols = np.asarray(js.color_features).copy()
    cols[:n] = rng.normal(size=(n, cols.shape[1]))
    js = js._replace(geo_features=jnp.asarray(feats), color_features=jnp.asarray(cols))
    geo = jdec.init_decoder(jax.random.PRNGKey(2), feats.shape[1] + 3, 64, 1, 1)
    col = jdec.init_decoder(jax.random.PRNGKey(3), feats.shape[1] + 3, 64, 1, 3)
    d = tmp_path_factory.mktemp("vis_maps")
    jexp.save_implicit_map(str(d / "jax" / "pin_map.npz"), js, geo, None, col)
    texp.save_implicit_map(str(d / "torch" / "pin_map.npz"), tn.state_from_numpy(js),
                           decoder_from_jax(geo), color_decoder=decoder_from_jax(col))
    crop = str(d / "crop.ply")
    tio.write_ply(crop, np.asarray([[-4.0, -3.0, -0.6], [0.0, 0.0, 0.6]], np.float32))
    return dict(dir=d, n=n, crop=crop)


def _mesh(path):
    m = tio.read_ply(path)
    return np.stack([m["x"], m["y"], m["z"]], 1), m["faces"], m


@pytest.mark.parametrize("crop", [False, True], ids=["whole", "cropped"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vis_pin_map_matches_jax(saved, writer, crop, tmp_path):
    import vis_pin_map as jvis

    from pin_slam_torch import vis_pin_map as tvis

    src = str(saved["dir"] / writer / "pin_map.npz")
    extra = [saved["crop"]] if crop else []
    outs = {}
    for name, main, tail in (("jax", jvis.main, []), ("torch", tvis.main, ["--device", "cpu"])):
        out = str(tmp_path / name / "mesh.ply")
        os.makedirs(os.path.dirname(out))
        assert main([src, "0.3", out] + extra + tail) == 0
        assert os.path.getsize(os.path.join(os.path.dirname(out), "viewer.html")) > 0
        outs[name] = _mesh(out)
    (vt, ft, mt), (vj, fj, mj) = outs["torch"], outs["jax"]
    assert len(vj) > 200 and abs(len(vt) - len(vj)) <= 0.01 * len(vj)
    assert abs(len(ft) - len(fj)) <= 0.01 * len(fj)
    from scipy.spatial import cKDTree

    for a, b in ((vt, vj), (vj, vt)):
        assert cKDTree(b).query(a)[0].max() < 1e-3
    assert {"red", "nx"} <= mt.keys() and {"red", "nx"} <= mj.keys()
    # the crop keeps the points up to x = y = 1 (its box plus 1 m), meshed
    # with the chunk's 1 m pad and two voxels; the whole map reaches x = 4
    assert (vt[:, 0].max() < 3.0) == crop


def test_vis_pin_map_loads_on_the_gpu_unless_asked(saved, monkeypatch):
    from pin_slam_torch import vis_pin_map as tvis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvis.main([str(saved["dir"] / "torch")])
