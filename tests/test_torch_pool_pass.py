"""The pool pass's plain twin (``ops/pool_kernel.pool_pass_plain``: the
port's ``pool_retransform`` then ``pool_refresh_cache``) against the JAX
package's two functions on one synthetic pool, poses and attribute table
(CPU), at k 6 / 8 and in both layouts: live rows with neighbours inside and
past ``max_valid_dist2``, negative and clamped neighbour ids, negative frame
ids, rows with no neighbour, and rows past the fill.  Then the route: CPU
tensors and encoded rows take the twin, a CUDA layout the kernel does not
take raises, and the wrapper refuses what the kernel would.

Tolerances are test_torch_map_deform.py's: pool coordinates are 3x3
matrix-vector products of ~50 m coordinates (summation order may differ:
atol 2e-5 m, 3 ulps at 64 m); IDW weights and offset vectors rtol 1e-5 /
atol 1e-6, with the JAX refresh reading the port's coordinates, as that test
refreshes both from one pool: one ulp of a 64 m coordinate (7.6e-6 m) moves
a weight at a 0.3 m offset by ~5e-5 of itself.  At k = 8 the JAX side is
its ``idw_blend`` of the same neighbours (its refresh reads the k = 6
layout)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_, small_config

torch.set_num_threads(1)
CAP = 1 << 12             # the map's capacity: the attribute table's sentinel row
N, FILL, T = 3000, 2400, 40


def _configs(k, wf):
    from pin_slam_torch.config import Config
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_torch.slam import mapper as tm
    from pin_slam_tpu.models import neural_points as jn

    cfg = small_config(Config, query_nn_k=k, weighted_first=wf, pool_capacity=N - 1)
    assert cfg.map_capacity == CAP
    return tn.MapConfig.from_config(cfg), jn.MapConfig.from_config(cfg), \
        tm.MapperConfig.from_config(cfg)


def _rigid(rng, angle, shift):
    from scipy.spatial.transform import Rotation

    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * angle).as_matrix()
    P[:3, 3] = rng.uniform(-shift, shift, 3)
    return P


def _inputs(k, wf, seed=0):
    """(rows, poses, attr) of a pool whose live rows sit near clusters
    of 8 map points; a tenth of their ids are -1, a tenth name another
    cluster's point (past max_valid_dist2), a few name the sentinel or past
    it; a few frame ids are -1; every 50th live row has no neighbour."""
    from pin_slam_torch.models import neural_points as tn

    _, _, mcfg = _configs(k, wf)
    rng = np.random.default_rng(seed)
    poses = np.stack([_rigid(rng, 0.3, 50.0) for _ in range(T)])
    n_cl = (CAP - 8) // 8
    centre = rng.uniform(-50, 50, (n_cl, 3)).astype(np.float32)
    pos = (centre[:, None, :] + rng.normal(0, 0.25, (n_cl, 8, 3))).reshape(-1, 3)
    attr = np.zeros((CAP + 1, tn.ATTR_DIM), np.float32)
    attr[:len(pos), :3] = pos
    q = np.concatenate([np.ones((len(pos), 1)), rng.normal(0, 0.1, (len(pos), 3))], 1)
    attr[:len(pos), 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    attr[len(pos):, 3] = 1.0
    attr[CAP] = np_(tn.attr_sentinel_row())
    rows = np.zeros((N, mcfg.pool_dim), np.float32)
    rows[:, mcfg.p_knn] = -1.0
    cl = rng.integers(0, n_cl, FILL)
    ts = rng.integers(0, T, FILL)
    target = centre[cl] + rng.normal(0, 0.3, (FILL, 3))
    R, t = poses[ts, :3, :3].astype(np.float64), poses[ts, :3, 3].astype(np.float64)
    local = np.einsum("nji,nj->ni", R, target - t)
    ids = cl[:, None] * 8 + np.stack([rng.permutation(8)[:k] for _ in range(FILL)])
    u = rng.uniform(size=(FILL, k))
    ids = np.where(u < 0.1, -1, ids)
    ids = np.where((u >= 0.1) & (u < 0.2), rng.integers(0, len(pos), (FILL, k)), ids)
    ids = np.where(u > 0.995, CAP + rng.integers(0, 3, (FILL, k)), ids)
    ids[::50] = -1
    ts = np.where(rng.uniform(size=FILL) < 0.02, -1, ts)
    rows[:FILL, 5] = ts
    rows[:FILL, 6:9] = local
    rows[:FILL, mcfg.p_knn] = ids
    rows[:FILL, 3:5] = rng.normal(size=(FILL, 2))
    # stale cached geometry, which the pass overwrites
    rows[:FILL, :3] = rng.normal(size=(FILL, 3))
    rows[:FILL, mcfg.p_w.start:] = rng.normal(size=(FILL, mcfg.pool_dim - mcfg.p_w.start))
    return rows, poses, attr


def _pool(rows):
    from pin_slam_torch.slam import mapper as tm

    z = torch.zeros((), dtype=torch.int64)
    return tm.PoolState(rows=torch.as_tensor(rows.copy()), head=z + FILL, fill=z + FILL,
                        new_idx=torch.zeros((4,), dtype=torch.int64), new_count=z)


def _jax_pass(rows, poses, attr, k, coord):
    """The JAX package's pool_retransform (its coordinates), then on the
    rows with ``coord`` its pool_refresh_cache (k = 6) or its idw_blend of
    the same neighbours (k = 8)."""
    from pin_slam_tpu.slam import mapper as jm

    _, jmc, _ = _configs(k, rows.shape[1] == 12 + 2 * k)

    def pool(r):
        return jm.PoolState(rows=jnp.asarray(r), sem_label=None, color_label=None,
                            head=jnp.int32(FILL), fill=jnp.int32(FILL),
                            new_idx=jnp.zeros((4,), jnp.int32), new_count=jnp.int32(0))

    out = np_(jax.jit(jm.pool_retransform)(pool(rows), jnp.asarray(poses)).rows).copy()
    jcoord = out[:, :3].copy()
    out[:, :3] = coord
    if k == 6:
        out = np_(jm.pool_refresh_cache(pool(out), jnp.asarray(attr), jmc).rows).copy()
        out[:, :3] = jcoord
        return out
    gidx = rows[:, 9:9 + k].astype(np.int64)
    nbr = attr[np.where(gidx >= 0, np.minimum(gidx, CAP), CAP)]
    coord = out[:, :3]
    d = nbr[..., :3] - coord[:, None, :]
    valid = (gidx >= 0) & ((d * d).sum(-1) <= jmc.max_valid_dist2)
    w, vb, e = jax.jit(jm.idw_blend, static_argnames=("pos_encode", "return_per_neighbor"))(
        jnp.asarray(coord), jnp.asarray(nbr[..., :3]), jnp.asarray(valid),
        jnp.asarray(nbr[..., 3:7]), return_per_neighbor=True)
    out[:, 9 + k:9 + 2 * k] = np_(w)
    vec = [np_(vb)] + ([] if rows.shape[1] == 12 + 2 * k else [np_(e).reshape(len(out), -1)])
    out[:, 9 + 2 * k:] = np.concatenate(vec, 1)
    out[:, :3] = jcoord
    return out


@pytest.mark.parametrize("wf", [True, False], ids=["wf", "per_neighbor"])
@pytest.mark.parametrize("k", [6, 8])
def test_pool_pass_plain_matches_jax(k, wf):
    from pin_slam_torch.ops import pool_kernel as pk

    tmc, _, mcfg = _configs(k, wf)
    rows, poses, attr = _inputs(k, wf)
    assert rows.shape[1] == 12 + 2 * k + (0 if wf else 3 * k)
    got = np_(pk.pool_pass_plain(_pool(rows), torch.as_tensor(poses), torch.as_tensor(attr),
                                 tmc).rows)
    ref = _jax_pass(rows, poses, attr, k, got[:, :3])
    w0 = mcfg.p_w.start
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[:, 3:w0], rows[:, 3:w0])
    np.testing.assert_array_equal(ref[:, 3:w0], rows[:, 3:w0])
    np.testing.assert_allclose(got[:, w0:], ref[:, w0:], rtol=1e-5, atol=1e-6)
    # the cases the pass has to tell apart all occur
    w = got[:FILL, mcfg.p_w]
    ids = rows[:FILL, mcfg.p_knn]
    assert ((ids >= 0) & (w > 0)).mean() > 0.5                  # valid neighbours
    assert ((ids >= 0) & (w == 0)).mean() > 0.05                # past max_valid_dist2
    assert (ids >= CAP).any() and (rows[:FILL, 5] < 0).any()
    np.testing.assert_allclose(w[(w > 0).any(1)].sum(1), 1.0, rtol=1e-5)
    assert not got[:FILL:50, w0:].any()                         # no neighbour: all zero
    # rows past the fill: the first pose's translation, zero weights and vectors
    np.testing.assert_array_equal(got[FILL:, :3], np.broadcast_to(poses[0, :3, 3], (N - FILL, 3)))
    assert not got[FILL:, w0:].any()


@pytest.mark.parametrize("case,route", [
    (dict(k=6, width=42, encoded=False, cuda=False), "chunked"),
    (dict(k=6, width=42, encoded=False, cuda=True), "kernel"),
    (dict(k=6, width=24, encoded=False, cuda=True), "kernel"),
    (dict(k=8, width=52, encoded=False, cuda=True), "kernel"),
    (dict(k=1, width=14, encoded=False, cuda=True), "kernel"),
    (dict(k=6, width=210, encoded=True, cuda=True), "chunked"),
    (dict(k=6, width=56, encoded=True, cuda=False), "chunked"),
    (dict(k=9, width=57, encoded=False, cuda=True), None),
    (dict(k=6, width=43, encoded=False, cuda=True), None),
    (dict(k=16, width=92, encoded=False, cuda=True), None)],
    ids=["cpu", "kitti", "wf", "k8", "k1", "encoded", "encoded_cpu", "k9", "width43", "k16"])
def test_pool_route(case, route):
    from pin_slam_torch.ops import pool_kernel as pk

    if route is None:
        with pytest.raises(NotImplementedError, match="pool-pass kernel"):
            pk.pool_route(**case)
    else:
        assert pk.pool_route(**case) == route


def test_wrapper_takes_the_twin_on_the_cpu_and_refuses_what_the_kernel_would(monkeypatch):
    """On the CPU ``pool_pass`` gives the twin's bits and counts one pass and
    no launch; encoded rows reach the chunked refresh with their encoder;
    malformed inputs raise on the CPU as they would on the card."""
    from pin_slam_torch.ops import _cuda
    from pin_slam_torch.ops import pool_kernel as pk
    from pin_slam_torch.slam import mapper as tm
    from pin_slam_torch.utils import tracing

    tmc, _, _ = _configs(6, False)
    rows, poses, attr = _inputs(6, False, seed=1)
    P, A = torch.as_tensor(poses), torch.as_tensor(attr)
    launches = _cuda.COUNTS["pool_pass"]
    with tracing.frame(0) as report:
        got = pk.pool_pass(_pool(rows), P, A, tmc).rows
    assert report["counts"]["pool.passes"] == 1
    assert _cuda.COUNTS["pool_pass"] == launches
    assert torch.equal(got, pk.pool_pass_plain(_pool(rows), P, A, tmc).rows)

    seen = []
    refresh = tm.pool_refresh_cache
    monkeypatch.setattr(tm, "pool_refresh_cache",
                        lambda *a: seen.append(a[3]) or refresh(*a[:3]))
    enc = object()
    pk.pool_pass(_pool(rows), P, A, tmc, enc)
    assert seen == [enc]

    bad = [(_pool(rows[:, :-1].copy()).rows.t().contiguous().t(), P, A),   # strided rows
           (_pool(rows).rows, P[:, :3], A),                                # 3x4 poses
           (_pool(rows).rows, P.double(), A),
           (_pool(rows).rows, P, A[:CAP]),                                 # no sentinel row
           (_pool(rows).rows, P, A[:, :7])]                                # narrow attribute rows
    for r, p, a in bad:
        with pytest.raises(ValueError):
            pk.pool_pass(dataclasses.replace(_pool(rows), rows=r), p, a, tmc)


def test_pool_readers_read_the_reports():
    """``pool_pass_ms``: the closure's and BA's pool spans over the passes;
    ``pool_kernel_share``: the kernel's launches over the passes; both None
    where no pass ran (a drive, or the parent's reports, which count none)."""
    import types

    from slambench import harness

    ms, share = harness.metric_reader("pool_pass_ms"), harness.metric_reader("pool_kernel_share")

    def report(deform=None, ba=None, passes=0, launched=0):
        spans = {"pin_slam.pgo": 50.0}
        spans.update({"pin_slam.pgo.deform.pool": deform} if deform is not None else {})
        spans.update({"pin_slam.pgo.ba.pool": ba} if ba is not None else {})
        return {"trace": {"span_ms": spans, "counts": {"pool.passes": passes} if passes else {},
                          "launches": {"pool_pass": launched} if launched else {}}}

    run = harness.RunRecord(infos=[report(deform=6.0, passes=1, launched=1), report(),
                                   report(ba=3.0, passes=1, launched=1), {"skipped": True}])
    assert ms(run) == pytest.approx(4.5) and share(run) == 1.0
    chunked = harness.RunRecord(infos=[report(deform=180.0, passes=1), report(ba=3.0, passes=1,
                                                                          launched=1)])
    assert share(chunked) == 0.5 and ms(chunked) == pytest.approx(91.5)
    parent = harness.RunRecord(infos=[{"trace": {"span_ms": {"pin_slam.pgo.deform": 175.0},
                                                 "counts": {}, "launches": {}}}])
    for read in (ms, share):
        assert read(harness.RunRecord()) is None and read(parent) is None
        assert read(types.SimpleNamespace(infos=[report()])) is None
