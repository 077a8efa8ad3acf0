"""The port's mesher (pin_slam_torch.slam.mesher, ops/marching_cubes.py and the
end-of-run map operations build_query_view / finalize_map) against the JAX
package on the CPU.

Integers must match exactly: the view's indices, count, member mask and
packed hash rows; finalize_map's count, hash table and compacted rows; the
grid query's neighbour counts; the extraction on the same SDF grid (vertices
and faces bit for bit).  The grid query's SDF is held to SDF_ATOL.  Built
from the port's own SDF, a mesh may differ by the few triangles whose corner
values straddle zero within that rounding: its vertex count is held to
VERT_SHARE of JAX's and its Chamfer distance to CHAMFER_FRAC of mc_res_m."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

from pin_slam_torch.config import Config as TConfig
from pin_slam_torch.models import neural_points as tn
from pin_slam_torch.models.decoder import decoder_from_jax
from pin_slam_torch.ops import marching_cubes as tmc_mod
from pin_slam_torch.slam import mesher as tm
from pin_slam_torch.utils import native as tnative
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import neural_points as jn
from pin_slam_tpu.ops import marching_cubes as jmc_mod
from pin_slam_tpu.slam import mesher as jm

torch.set_num_threads(1)

SDF_ATOL = 1e-5          # grid-query SDF, float32 (measured: 2.4e-7)
VERT_SHARE = 0.01        # own-SDF mesh: |V_port - V_jax| <= 1 % of V_jax
CHAMFER_FRAC = 0.01      # own-SDF mesh: Chamfer-L1 <= 1 % of mc_res_m
MC_RES = 0.2


# ----------------------------------------------------------------------
# the seven cases of tests/test_marching_cubes.py, on the port's copy
# ----------------------------------------------------------------------


def sphere_grid(n=48, r=1.0, half=1.5):
    xs = np.linspace(-half, half, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    sdf = np.linalg.norm(g, axis=-1) - r
    return sdf, (-half, -half, -half), xs[1] - xs[0]


def plane_grid(n=16):
    xs = np.linspace(0, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return g[..., 2] - 0.5, (0, 0, 0), xs[1] - xs[0]


def _sphere_surface(m):
    sdf, origin, spacing = sphere_grid()
    verts, faces = m.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    assert verts.shape[0] > 500 and faces.shape[0] > 500
    radii = np.linalg.norm(verts, axis=1)
    np.testing.assert_allclose(radii.mean(), 1.0, atol=0.01)
    assert radii.std() < 0.01
    assert faces.max() < verts.shape[0]


def _sphere_area(m):
    sdf, origin, spacing = sphere_grid(n=64)
    verts, faces = m.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    fv = verts[faces]
    areas = 0.5 * np.linalg.norm(np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), axis=1)
    np.testing.assert_allclose(areas.sum(), 4 * np.pi, rtol=0.03)


def _mask_blocks_cells(m):
    sdf, origin, spacing = sphere_grid()
    mask = np.zeros(sdf.shape, dtype=bool)
    mask[:, :, : sdf.shape[2] // 2] = True
    verts, _ = m.marching_tetrahedra(sdf, mask, origin=origin, spacing=spacing)
    assert verts.shape[0] > 100
    assert (verts[:, 2] <= 0.05).all()


def _plane_surface(m):
    sdf, origin, spacing = plane_grid()
    verts, faces = m.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    np.testing.assert_allclose(verts[:, 2], 0.5, atol=1e-6)
    assert faces.shape[0] >= 2 * (16 - 1) ** 2


def _empty_and_degenerate(m):
    verts, faces = m.marching_tetrahedra(np.ones((8, 8, 8)))
    assert verts.shape[0] == 0 and faces.shape[0] == 0
    verts, _ = m.marching_tetrahedra(np.ones((1, 5, 5)))
    assert verts.shape[0] == 0


def _filter_isolated_vertices(m):
    sdf, origin, spacing = sphere_grid(n=40)
    verts, faces = m.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    v2, _ = m.filter_isolated_vertices(verts, faces, min_cluster=10)
    assert v2.shape[0] == verts.shape[0]
    v3, _ = m.filter_isolated_vertices(verts, faces, min_cluster=verts.shape[0] + 1)
    assert v3.shape[0] == 0


def _vertex_normals_point_outward(m):
    sdf, origin, spacing = sphere_grid(n=40)
    verts, faces = m.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    vn = m.vertex_normals(verts, faces)
    outward = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    assert np.abs((vn * outward).sum(1)).mean() > 0.95


@pytest.mark.parametrize("case", [
    _sphere_surface, _sphere_area, _mask_blocks_cells, _plane_surface,
    _empty_and_degenerate, _filter_isolated_vertices, _vertex_normals_point_outward],
    ids=lambda f: f.__name__.lstrip("_"))
def test_marching_cubes_cases(case):
    case(tmc_mod)


def _masked_sphere():
    sdf, origin, spacing = sphere_grid()
    mask = np.random.default_rng(2).random(sdf.shape) > 0.1
    mask[:, :, : sdf.shape[2] // 3] = False
    return sdf, mask, origin, spacing


@pytest.mark.parametrize("grid", ["sphere", "plane", "masked"])
def test_extraction_bit_equal_to_jax(grid):
    """numpy extraction and the cluster filter and normals after it: the
    same bits as the JAX package's."""
    if grid == "masked":
        sdf, mask, origin, spacing = _masked_sphere()
    else:
        (sdf, origin, spacing), mask = (sphere_grid() if grid == "sphere" else plane_grid()), None
    vj, fj = jmc_mod.marching_tetrahedra(sdf, mask, origin=origin, spacing=spacing,
                                         use_native=False)
    vt, ft = tmc_mod.marching_tetrahedra(sdf, mask, origin=origin, spacing=spacing,
                                         use_native=False)
    assert vt.shape[0] > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    for a, b in zip(tmc_mod.filter_isolated_vertices(vt, ft, 50),
                    jmc_mod.filter_isolated_vertices(vj, fj, 50)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmc_mod.vertex_normals(vt, ft),
                                  jmc_mod.vertex_normals(vj, fj))


def _chamfer(a, b):
    from scipy.spatial import cKDTree

    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("masked", [False, True])
def test_native_extraction_within_bounds(masked, tmp_path):
    """The port's loader of the native extension (built here if absent) and
    numpy agree within tests/test_native.py's bounds: vertex counts within
    2, face counts within 4, Chamfer < 1e-5."""
    if not tnative.available():
        tnative.build(str(tmp_path))
    if masked:
        sdf, mask, origin, spacing = _masked_sphere()
    else:
        (sdf, origin, spacing), mask = sphere_grid(), None
    v_py, f_py = tmc_mod.marching_tetrahedra(sdf, mask, origin=origin, spacing=spacing,
                                             use_native=False)
    v_c, f_c = tmc_mod.marching_tetrahedra(sdf, mask, origin=origin, spacing=spacing,
                                           use_native=True)
    assert abs(len(v_c) - len(v_py)) <= 2 and abs(len(f_c) - len(f_py)) <= 4
    assert _chamfer(v_c, v_py) < 1e-5


def test_pin_native_0_selects_numpy(monkeypatch):
    sdf, origin, spacing = sphere_grid(n=24)
    calls = []
    monkeypatch.setattr(tnative, "marching_tetrahedra", lambda *a, **k: calls.append(1))
    monkeypatch.setattr(tnative, "available", lambda: True)
    monkeypatch.setenv("PIN_NATIVE", "0")
    v, _ = tmc_mod.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    assert not calls and v.shape[0] > 0
    monkeypatch.setenv("PIN_NATIVE", "1")
    tmc_mod.marching_tetrahedra(sdf, origin=origin, spacing=spacing)
    assert calls


# ----------------------------------------------------------------------
# a small map, carried across: a bumpy ground surface whose decoder reads
# the offset's z (ReLU(z) - ReLU(-z)) plus small random terms, so the SDF
# has a real zero crossing
# ----------------------------------------------------------------------


def _map(wf=True, brick="auto", L=1 << 12, seed=0):
    over = dict(map_capacity=1 << 14, local_map_capacity=L, buffer_size=1 << 16,
                downsample_hash_size=1 << 16, weighted_first=wf, use_brick_hash=brick)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    assert jmc.local_hash_size == tmc.local_hash_size and jmc.nsub == tmc.nsub
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-4, 4, (6000, 2))
    z = 0.3 * np.sin(xy[:, 0]) + 0.2 * np.cos(0.7 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    js = jn.map_insert(jn.init_map_state(jmc), jmc, jnp.asarray(pts),
                       jnp.ones(len(pts), bool), jnp.int32(0), jnp.zeros(64, jnp.float32),
                       downsample_table_size=1 << 16)
    feats = np.zeros(np.asarray(js.geo_features).shape, np.float32)
    n = int(js.count)
    feats[:n] = 0.1 * rng.standard_normal((n, feats.shape[1]))
    js = js._replace(geo_features=jnp.asarray(feats))
    F, H = jcfg.feature_dim, 16
    p = jdec.init_decoder(jax.random.PRNGKey(seed + 1), F + 3, H, 1, 1)
    (W1, b1), = p.hidden
    W1, b1 = np.array(W1) * 0.05, np.array(b1) * 0.05
    W2 = np.array(p.out[0]) * 0.05
    W1[F + 2, :2], b1[:2], W2[:2, 0] = (1.0, -1.0), 0.0, (1.0, -1.0)
    p = jdec.DecoderParams(hidden=((jnp.asarray(W1), jnp.asarray(b1)),),
                           out=(jnp.asarray(W2), jnp.zeros((1,), jnp.float32)))
    offsets = jn.neighbor_offsets(jcfg.num_nei_cells, jcfg.search_alpha)
    return dict(jcfg=jcfg, jmc=jmc, tmc=tmc, js=js, ts=tn.state_from_numpy(js), p=p,
                dec=decoder_from_jax(p), offsets=offsets)


def _view_fields(tv, jv):
    for f in ("indices", "count", "member_mask", "hash_rows", "attr_rows", "geo_features",
              "lo1", "lo2", "origin"):
        np.testing.assert_array_equal(np_(getattr(tv, f)), np_(getattr(jv, f)), err_msg=f)


@pytest.mark.parametrize("brick", ["auto", "false"])
@pytest.mark.parametrize("radius", [2.5, 50.0])
def test_build_query_view_matches(brick, radius):
    """radius 2.5 m holds ~1/4 of the map; 50 m holds all of it, which
    overflows L = 512 (the oldest 512 are kept)."""
    m = _map(brick=brick, L=1 << 9)
    n = int(m["js"].count)
    assert n > 1 << 9
    center = np.asarray([0.3, -0.7, 0.1], np.float32)
    jv = jn.build_query_view(m["js"], m["jmc"], jnp.asarray(center), jnp.float32(radius))
    tv = tn.build_query_view(m["ts"], m["tmc"], torch.as_tensor(center), np.float32(radius))
    _view_fields(tv, jv)
    if radius > 10:
        assert int(tv.count) == 1 << 9
        np.testing.assert_array_equal(np_(tv.indices[:-1]), np.arange(1 << 9))
    else:
        assert 0 < int(tv.count) < 1 << 9


def test_finalize_map_matches():
    """tests/test_finalize.py's scenario: two passes over the same voxels
    (ts 0 and 40, travel 80 m apart), the recent pass certain; finalize_map
    merges and prunes to the same survivors, in the same order, with the
    same hash table, as the JAX package."""
    over = dict(map_capacity=1 << 12, local_map_capacity=1 << 10, buffer_size=1 << 14,
                voxel_size_m=0.3)
    jcfg, tcfg = small_config(JConfig, **over), small_config(TConfig, **over)
    jmc, tmc = jn.MapConfig.from_config(jcfg), tn.MapConfig.from_config(tcfg)
    rng = np.random.default_rng(0)
    travel = np.arange(64, dtype=np.float32) * 2.0
    pts1 = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    jitter = rng.uniform(-0.05, 0.05, size=pts1.shape).astype(np.float32)
    state, counts = jn.init_map_state(jmc), []
    for ts, pts in ((0, pts1), (40, pts1 + jitter)):
        state = jn.map_insert(state, jmc, jnp.asarray(pts), jnp.ones((500,), bool),
                              jnp.int32(ts), jnp.asarray(travel), downsample_table_size=1 << 14)
        counts.append(int(state.count))
    n1, n2 = counts
    assert n2 > n1 > 300
    attr = state.attr_rows.at[n1:n2, jn.C_CERT].set(10.0)
    feats = np.asarray(state.geo_features).copy()
    feats[:n2] = rng.standard_normal((n2, feats.shape[1]))
    state = state._replace(attr_rows=attr, geo_features=jnp.asarray(feats))
    tstate = tn.state_from_numpy(state)
    jf = jn.finalize_map(state, jmc, jnp.asarray(travel), jnp.int32(40),
                         prune_certainty_thre=2.0, downsample_table_size=1 << 14)
    tf = tn.finalize_map(tstate, tmc, torch.as_tensor(travel), 40, prune_certainty_thre=2.0,
                         downsample_table_size=1 << 14)
    n3 = int(jf.count)
    assert int(tf.count) == n3 and n3 < n2
    for f in ("hash_table", "attr_rows", "geo_features"):
        np.testing.assert_array_equal(np_(getattr(tf, f)), np_(getattr(jf, f)), err_msg=f)
    assert int(tstate.count) == n2          # the input state is left as it was


@pytest.mark.parametrize("wf", [True, False])
def test_grid_query_matches(wf):
    """SDF and neighbour counts on a grid, from the same view and decoder."""
    m = _map(wf=wf)
    center = np.zeros(3, np.float32)
    jv = jn.build_query_view(m["js"], m["jmc"], jnp.asarray(center), jnp.float32(20.0))
    tv = tn.local_map_from_numpy(jv)
    cfg = dict(mc_res_m=MC_RES, mesh_min_nn=4, query_bucket=1 << 12)
    jmesh = jm.Mesher(jm.MesherConfig(**cfg), m["jmc"], jnp.asarray(m["offsets"]))
    tmesh = tm.Mesher(tm.MesherConfig(**cfg), m["tmc"], torch.as_tensor(m["offsets"]))
    g = np.random.default_rng(5).uniform([-4, -4, -1], [4, 4, 1], (10000, 3)).astype(np.float32)
    g[:100] = np.asarray(m["js"].attr_rows[:100, :3])          # on map points
    sj, nj = jmesh.query_sdf_grid(jv, m["p"], 1.0, g)
    st, nt = tmesh.query_sdf_grid(tv, m["dec"], 1.0, g)
    assert nt.dtype == nj.dtype and (nj > 0).mean() > 0.5
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=SDF_ATOL)


@pytest.mark.parametrize("wf", [True, False])
def test_recon_aabb_mesh_matches(wf, monkeypatch):
    """On JAX's own SDF grid the port's box reconstruction is bit-equal; from
    its own SDF it is within VERT_SHARE / CHAMFER_FRAC."""
    monkeypatch.setenv("PIN_NATIVE", "0")
    m = _map(wf=wf)
    center = np.zeros(3, np.float32)
    jv = jn.build_query_view(m["js"], m["jmc"], jnp.asarray(center), jnp.float32(20.0))
    tv = tn.build_query_view(m["ts"], m["tmc"], torch.as_tensor(center), np.float32(20.0))
    cfg = dict(mc_res_m=MC_RES, mesh_min_nn=4, min_cluster_vertices=50, query_bucket=1 << 13)
    jmesh = jm.Mesher(jm.MesherConfig(**cfg), m["jmc"], jnp.asarray(m["offsets"]))
    tmesh = tm.Mesher(tm.MesherConfig(**cfg), m["tmc"], torch.as_tensor(m["offsets"]))
    amin, amax = np.array([-3.0, -3.0, -1.0]), np.array([3.0, 3.0, 1.0])
    vj, fj, cj, sj = jmesh.recon_aabb_mesh(jv, m["p"], 1.0, amin, amax)
    assert vj.shape[0] > 1000 and cj is None and sj is None

    vt, ft = tmesh.recon_aabb_mesh(tv, m["dec"], 1.0, amin, amax)
    assert abs(len(vt) - len(vj)) <= VERT_SHARE * len(vj)
    assert _chamfer(vt, vj) <= CHAMFER_FRAC * MC_RES
    assert np.isfinite(vt).all()

    monkeypatch.setattr(tmesh, "query_sdf_grid", lambda lm, dec, scale, coords:
                        jmesh.query_sdf_grid(jv, m["p"], 1.0, coords))
    vt2, ft2 = tmesh.recon_aabb_mesh(tv, m["dec"], 1.0, amin, amax)
    np.testing.assert_array_equal(vt2, vj)
    np.testing.assert_array_equal(ft2, fj)
    # the collection of one box is the box, with one view or a view per box
    boxes = []
    for lm in (tv, lambda a, b: boxes.append((a, b)) or tv):
        v3, f3 = tmesh.recon_aabb_collections_mesh(lm, m["dec"], 1.0, [(amin, amax)])
        np.testing.assert_array_equal(v3, vj)
        np.testing.assert_array_equal(f3, fj)
    assert len(boxes) == 1 and boxes[0][0] is amin
    # two boxes, a view built for each: JAX's collection, faces offset alike
    two = [(amin, np.array([0.5, 3.0, 1.0])), (np.array([-0.5, -3.0, -1.0]), amax)]
    vj2, fj2, _, _ = jmesh.recon_aabb_collections_mesh(jv, m["p"], 1.0, two)
    v4, f4 = tmesh.recon_aabb_collections_mesh(lambda a, b: tv, m["dec"], 1.0, two)
    assert len(vj2) > len(vj) and f4.max() == len(v4) - 1
    np.testing.assert_array_equal(v4, vj2)
    np.testing.assert_array_equal(f4, fj2)


def test_sdf_slice_matches():
    m = _map()
    center = np.zeros(3, np.float32)
    jv = jn.build_query_view(m["js"], m["jmc"], jnp.asarray(center), jnp.float32(20.0))
    cfg = dict(mc_res_m=MC_RES, query_bucket=1 << 12)
    jp, js_ = jm.Mesher(jm.MesherConfig(**cfg), m["jmc"], jnp.asarray(m["offsets"])).sdf_slice(
        jv, m["p"], 1.0, np.array([0.5, 0.0, 0.0]), 3.0, 0.2)
    tp, ts_ = tm.Mesher(tm.MesherConfig(**cfg), m["tmc"], torch.as_tensor(m["offsets"])).sdf_slice(
        tn.local_map_from_numpy(jv), m["dec"], 1.0, np.array([0.5, 0.0, 0.0]), 3.0, 0.2)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(ts_, js_, rtol=0, atol=SDF_ATOL)


@pytest.mark.parametrize("chunk_m", [1.0, 3.3, 100.0])
def test_split_chunks_matches(chunk_m):
    pts = np.random.default_rng(1).uniform([-7, -2, -1], [9, 5, 3], (3000, 3))
    pts = pts[(pts[:, 0] < 0) | (pts[:, 1] > 2)]              # an L-shaped map
    a, b = tm.split_chunks(pts, chunk_m, pad=1.0), jm.split_chunks(pts, chunk_m, pad=1.0)
    assert len(a) == len(b) > 0
    for (a0, a1), (b0, b1) in zip(a, b):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    assert tm.split_chunks(pts[:0], chunk_m) == []


def test_unported_mesher_options_raise():
    m = _map()
    offs = torch.as_tensor(m["offsets"])
    with pytest.raises(NotImplementedError, match="ROADMAP A 11"):
        tm.Mesher(tm.MesherConfig(semantic_on=True), m["tmc"], offs)
    tm.Mesher(tm.MesherConfig(color_on=True), m["tmc"], offs)      # painting is ported
    with pytest.raises(NotImplementedError, match="ROADMAP A 12"):
        tm.Mesher(tm.MesherConfig(), m["tmc"], offs, dp_mesh=object())
    assert dataclasses.asdict(tm.MesherConfig()) == dataclasses.asdict(jm.MesherConfig())
