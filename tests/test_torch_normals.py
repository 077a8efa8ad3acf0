"""The port's source normals (``pin_slam_torch/ops/normals.py``) and the
tracker's normal-consistency weight against the JAX package's on the CPU.

Tolerances: the closed-form eigenpair within 1e-5 (vectors and values
relative to the matrix scale); ``estimate_normals``' validity masks exact
and its normals within 1e-5 at 98 % of the points and 1e-4 at all (the
covariance's sums run in another order, and on a scanned cloud both
packages' float32 normals lie up to 1.6e-4 from the float64 ones, so
rounding alone moves a few by more than 1e-5); ``track_frame`` with normals the same
iteration count and stop flags and a pose within 1e-4 m / 1e-5 rad.  The
JAX functions run jitted (XLA turns a division by a constant into a
multiplication by its float32 reciprocal, which the port copies)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

from pin_slam_torch.ops import normals as tnorm
from pin_slam_tpu.ops import normals as jnorm

torch.set_num_threads(1)


def _spd(rng, n, kind):
    """n symmetric PSD 3x3 matrices of one kind: generic (eigenvalues at
    least 0.1 apart), plane-like (one tiny eigenvalue), line-like (two),
    isotropic, or diagonal (the closed form's p1 = 0 branch)."""
    Q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    lam = np.array([0.05, 0.4, 0.9]) + rng.uniform(-0.04, 0.04, (n, 3))
    if kind == "plane":
        lam[:, 0] = 1e-6
    elif kind == "line":
        lam[:, :2] = 1e-6
    elif kind == "isotropic":
        lam[:] = lam[:, :1]
    elif kind == "diagonal":
        Q = np.broadcast_to(np.eye(3), Q.shape)
    return np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)


@pytest.mark.parametrize("kind", ["generic", "plane", "isotropic", "diagonal", "line"])
def test_smallest_eigenvector3_matches(kind):
    """Eigenvalue and eigenvector within 1e-5 of the jitted JAX function
    (unit length, and an eigenvector of the smallest eigenvalue).  A
    line-like matrix (a double smallest eigenvalue at 1e-6 of a unit-scale
    matrix) is ill-conditioned for the closed form in float32: the
    arccos's cancellation leaves its eigenvalue ~1e-4 off the exact one in
    either package (JAX eager and jitted differ by as much), so there the
    eigenvalue is held within 2e-4 and the eigenvector, any unit vector of
    the double eigenspace, only to unit length.  An isotropic matrix has
    no eigenvector to compare either."""
    C = _spd(np.random.default_rng(0), 200, kind)
    jv, jl = jax.jit(jnorm.smallest_eigenvector3)(jnp.asarray(C))
    tv, tl = tnorm.smallest_eigenvector3(torch.as_tensor(C))
    np.testing.assert_allclose(np.linalg.norm(np_(tv), axis=1), 1.0, atol=1e-5)
    if kind == "line":
        np.testing.assert_allclose(np_(tl), np_(jl), atol=2e-4)
        return
    np.testing.assert_allclose(np_(tl), np_(jl), atol=1e-5)
    if kind == "isotropic":
        return
    np.testing.assert_allclose(np_(tv), np_(jv), atol=1e-5)
    if kind in ("generic", "plane"):
        Cg, v = C.astype(np.float64), np_(tv).astype(np.float64)
        lam = np.linalg.eigvalsh(Cg)[:, 0]
        resid = np.einsum("nij,nj->ni", Cg, v) - lam[:, None] * v
        assert np.abs(resid).max() < 1e-3


def _cloud(rng):
    """A padded sensor-frame cloud of a voxel-downsampled scene: a floor, a
    wall and a pillar (planar, planar, curved), isolated points, two points
    in one 0.5 m cell (a shared hash slot), and padding."""
    floor = np.column_stack([rng.uniform(2, 12, 700), rng.uniform(-5, 5, 700),
                             -1.5 + 0.01 * rng.standard_normal(700)])
    wall = np.column_stack([rng.uniform(2, 12, 500), 6.0 + 0.01 * rng.standard_normal(500),
                            rng.uniform(-1.5, 2.0, 500)])
    ang = rng.uniform(0, 2 * np.pi, 200)
    pillar = np.column_stack([8 + 0.4 * np.cos(ang), -3 + 0.4 * np.sin(ang),
                              rng.uniform(-1.5, 2.0, 200)])
    lone = rng.uniform([-30, -30, 5], [30, 30, 8], (20, 3))
    twin = np.array([[20.1, 20.1, 0.1], [20.3, 20.2, 0.2]])
    pts = np.concatenate([floor, wall, pillar, lone, twin]).astype(np.float32)
    n = pts.shape[0]
    out = np.zeros((2048, 3), np.float32)
    out[:n] = pts
    valid = np.arange(2048) < n
    valid[rng.choice(n, 30, replace=False)] = False          # holes inside the cloud
    return out, valid


def _normals_close(t, j, valid):
    d = np.abs(np_(t) - np_(j)).max(1)[valid]
    assert (d <= 1e-5).mean() >= 0.98 and d.max() <= 1e-4, (np.sort(d)[-5:], valid.sum())


@pytest.mark.parametrize("hash_size", [1 << 16, 1 << 9], ids=["table_2e16", "colliding_2e9"])
def test_estimate_normals_matches(hash_size):
    """Validity exact, normals within 1e-5 (98 %) / 1e-4, on a cloud with planes, a
    pillar, isolated points, a shared hash slot and padding; the small table
    makes many cells share slots."""
    pts, valid = _cloud(np.random.default_rng(1))
    cell = 0.5
    f = jax.jit(jnorm.estimate_normals, static_argnums=(2, 3))
    jn_, jv = f(jnp.asarray(pts), jnp.asarray(valid), cell, hash_size)
    tn_, tv = tnorm.estimate_normals(torch.as_tensor(pts), torch.as_tensor(valid), cell,
                                     hash_size)
    np.testing.assert_array_equal(np_(tv), np_(jv))
    v = np_(jv)
    _normals_close(tn_, jn_, v)
    assert v[valid].mean() > 0.5 and not v[~valid].any()
    lone = slice(1400, 1420)
    assert not v[lone].any()                                  # isolated: no normal
    # the floor's normals point up (toward the sensor above it)
    fl = v[:700] & valid[:700]
    assert (np_(tn_)[:700][fl, 2] > 0.9).mean() > 0.9


def test_shared_slot_keeps_the_last_writer():
    """Two points of one cell: the table keeps the later one, as the JAX
    package's in-order scatter does, on every device."""
    from pin_slam_torch.ops.hash3d import grid_coords, spatial_hash
    from pin_slam_torch.ops.scatter import scatter_set_last

    pts = torch.tensor([[1.1, 1.1, 1.1], [1.3, 1.2, 1.4], [5.0, 5.0, 5.0]])
    slot = spatial_hash(grid_coords(pts, 0.5), 64)
    assert slot[0] == slot[1] != slot[2]
    table = scatter_set_last(torch.full((65, 3), 1e8), slot, pts)
    assert torch.equal(table[slot[0]], pts[1])
    jt = jax.jit(lambda s, p: jnp.full((65, 3), 1e8, jnp.float32).at[s].set(p))(
        jnp.asarray(np_(slot).astype(np.int32)), jnp.asarray(np_(pts)))
    np.testing.assert_array_equal(np_(table), np_(jt))


# ----------------------------------------------------------------------
# the tracker's normal-consistency weight
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def corridor_map(tmp_path_factory):
    """The port's SlamSystem after frame 0 of the labelled corridor (a
    trained map, per-neighbour decoding), the next frame's source cloud
    with its normals, and the JAX package's view of the local map."""
    from pin_slam_torch.config import Config
    from pin_slam_torch.slam.pipeline import SlamSystem
    from pin_slam_torch.utils import synthetic as syn
    from pin_slam_tpu.models import decoder as jdec
    from pin_slam_tpu.models import neural_points as jn

    scans, labels, poses, _ = syn.labelled_corridor_scans(0, 2, 1 << 13, n_az=900, n_el=96)
    root = str(tmp_path_factory.mktemp("corridor"))
    seq = syn.write_semantic_kitti_sequence(root, "00", scans, labels, poses)
    cfg = Config()
    cfg.pc_path, cfg.pose_path, cfg.calib_path = (f"{seq}/velodyne", f"{seq}/poses.txt",
                                                  f"{seq}/calib.txt")
    cfg.pgo_on, cfg.silence, cfg.estimate_normal = False, True, True
    cfg.weighted_first = False
    cfg.min_range, cfg.max_range = 2.0, 20.0
    cfg.map_capacity, cfg.local_map_capacity = 1 << 15, 1 << 13
    cfg.buffer_size, cfg.pool_capacity = 1 << 17, 1 << 17
    cfg.downsample_hash_size, cfg.frame_bucket, cfg.source_bucket = 1 << 16, 1 << 13, 1 << 11
    cfg.bs, cfg.iters, cfg.init_iter_ratio = 4096, 15, 20
    cfg._derive()
    s = SlamSystem(cfg, device="cpu")
    s.process_frame(s.dataset.preprocess_frame(0))
    f1 = s.dataset.preprocess_frame(1)
    src, src_valid = s._source_prep(torch.as_tensor(f1.points), torch.as_tensor(f1.valid))
    nrm, nrm_valid = s._source_normals(src, src_valid)
    lm = s.lm
    jmc = jn.MapConfig.from_config(cfg)
    jlm = jn.LocalMap(indices=jnp.asarray(np_(lm.indices).astype(np.int32)),
                      attr_rows=jnp.asarray(np_(lm.attr_rows)),
                      geo_features=jnp.asarray(np_(lm.geo_features)), color_features=None,
                      count=jnp.int32(int(lm.count)), member_mask=jnp.asarray(np_(lm.member_mask)),
                      lo1=jnp.int32(int(lm.lo1)), lo2=jnp.int32(int(lm.lo2)),
                      origin=jnp.asarray(np_(lm.origin)), hash_rows=jnp.asarray(np_(lm.hash_rows)))
    layers = [(jnp.asarray(np_(W).copy()), jnp.asarray(np_(b).copy()))
              for W, b in s.decoder.layers()]
    jgeo = jdec.DecoderParams(hidden=tuple(layers[:-1]), out=layers[-1])
    return dict(s=s, cfg=cfg, jmc=jmc, jlm=jlm, jgeo=jgeo, src=src, src_valid=src_valid,
                nrm=nrm, nrm_valid=nrm_valid)


def test_source_normals_match_jax(corridor_map):
    """The pipeline's source normals (cell max(source_vox_down_m, 1e-3))
    against JAX estimate_normals on the same source cloud."""
    d = corridor_map
    cell = max(d["cfg"].source_vox_down_m, 1e-3)
    jn_, jv = jax.jit(jnorm.estimate_normals, static_argnums=2)(
        jnp.asarray(np_(d["src"])), jnp.asarray(np_(d["src_valid"])), cell)
    np.testing.assert_array_equal(np_(d["nrm_valid"]), np_(jv))
    v = np_(jv)
    _normals_close(d["nrm"], jn_, v)
    valid_src = np_(d["src_valid"])
    assert v[valid_src].mean() > 0.5


@pytest.mark.parametrize("all_valid", [False, True], ids=["normal_valid", "all_normals"])
def test_track_frame_with_normals_matches(corridor_map, all_valid):
    """track_frame with the source normals (rotated by the current R; weight
    1 where a normal is invalid) against JAX track_frame from the same map
    and initial guess: the same iteration count and stop flags, the pose
    within 1e-4 m / 1e-5 rad; and the weight changes the result."""
    from pin_slam_torch.slam import tracker as ttrk
    from pin_slam_tpu.models import neural_points as jn
    from pin_slam_tpu.slam import tracker as jtrk

    d = corridor_map
    s, cfg = d["s"], d["cfg"]
    nv = torch.ones_like(d["nrm_valid"]) if all_valid else d["nrm_valid"]
    ttc = dataclasses.replace(s.tc, min_valid_ratio=0.1)
    jtc = dataclasses.replace(jtrk.TrackerConfig.from_config(cfg), min_valid_ratio=0.1)
    jt = jn.make_probe_template(d["jmc"], cfg.num_nei_cells, cfg.search_alpha)
    c, sn = np.cos(0.01), np.sin(0.01)
    R0 = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
    t0 = np.array([0.3, -0.05, 0.0], np.float32)
    jr = jtrk.track_frame(d["jlm"], d["jmc"], jtc, d["jgeo"], s.sdf_scale, jt,
                          jnp.asarray(np_(d["src"])), jnp.asarray(np_(d["src_valid"])),
                          jnp.asarray(R0), jnp.asarray(t0),
                          source_normals=jnp.asarray(np_(d["nrm"])),
                          source_normal_valid=jnp.asarray(np_(nv)))
    tr = ttrk.track_frame(s.lm, s.mc, ttc, s.decoder, s.sdf_scale, s.append_tmpl, d["src"],
                          d["src_valid"], torch.as_tensor(R0), torch.as_tensor(t0),
                          source_normals=d["nrm"], source_normal_valid=nv)
    assert (tr.iterations, tr.converged, tr.valid) == (int(jr.iterations), bool(jr.converged),
                                                       bool(jr.valid))
    assert tr.valid and tr.iterations > 2
    assert np.abs(np_(tr.t) - np_(jr.t)).max() < 1e-4, (np_(tr.t), np_(jr.t))
    dR = np_(tr.R).astype(np.float64).T @ np_(jr.R).astype(np.float64)
    skew = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    assert np.arcsin(min(np.linalg.norm(skew), 1.0)) < 1e-5
    plain = ttrk.track_frame(s.lm, s.mc, ttc, s.decoder, s.sdf_scale, s.append_tmpl,
                             d["src"], d["src_valid"], torch.as_tensor(R0),
                             torch.as_tensor(t0))
    assert np.abs(np_(plain.t) - np_(tr.t)).max() > 1e-5
