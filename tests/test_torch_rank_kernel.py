"""The rank kernels' plain twins (what pin_slam_torch runs on the CPU, and
what chip_smoke.py holds the CUDA kernels against on the card) against the
JAX package: the per-cell ``probe_rank`` against the Pallas kernel in
interpret mode and its XLA branch (exact_k_min), the fused brick probe +
rank ``probe_rank_brick`` against jitted ``_probe_rank`` in brick mode
through both.  Integer outputs and positions must match exactly, ties and
exhausted balls included; the wrappers refuse bad inputs before they look at
the device."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import np_

from pin_slam_torch.ops import rank_kernel as trk
from pin_slam_tpu.ops import rank_kernel as jrk

torch.set_num_threads(1)


def _inputs(rng, G, n, K, L):
    """Field-major candidate rows on a coarse lattice (many exact distance
    ties), a share of invalid local indices, sparse balls that run out of
    valid candidates before k."""
    xyz = np.round(rng.uniform(-1, 1, size=(G, 3, K)) * 4) / 4
    lidx = rng.integers(0, L + L // 3, size=(G, 1, K)).astype(np.float32)
    lidx[: G // 4, :, 3:] = L                       # exhausted balls: <= 3 valid
    gidx = rng.integers(0, 1 << 22, size=(G, 1, K)).astype(np.float32)
    rows = np.concatenate([xyz, lidx, gidx], axis=1).reshape(G, 5 * K).astype(np.float32)
    q = (np.round(rng.uniform(-1, 1, size=(G, n, 3)) * 4) / 4).astype(np.float32)
    return rows, q


def _xla_rank(rows, q, k, L, maxd2):
    """mapper._probe_rank's XLA branch on field-major rows."""
    from pin_slam_tpu.models.neural_points import exact_k_min

    G, n = q.shape[:2]
    K = rows.shape[1] // 5
    f = rows.reshape(G, 5, K)
    nbr = jnp.stack([f[:, 0], f[:, 1], f[:, 2]], -1)
    d = nbr[:, None] - q[:, :, None]
    d2 = jnp.sum(d * d, -1)
    valid = (f[:, None, 3].astype(jnp.int32) < L) & (d2 <= maxd2)
    sel = exact_k_min(jnp.where(valid, d2, 9e3), k)
    gid = jnp.take_along_axis(jnp.broadcast_to(f[:, None, 4], d2.shape), sel, 2)
    v = jnp.take_along_axis(valid, sel, 2)
    return jnp.where(v, jnp.round(gid).astype(jnp.int32), -1), v


@pytest.mark.parametrize("n,K", [(1, 33), (5, 33), (4, 132), (1, 6)])
def test_rank_plain_matches_pallas(n, K):
    rng = np.random.default_rng(n * 100 + K)
    G, k, L, maxd2 = 96, 6, 1000, 1.2
    rows, q = _inputs(rng, G, n, K, L)
    cfg = jrk.RankKernelConfig(G=G, n=n, K=K, k=k, L=L, max_valid_dist2=maxd2)
    g_j, p_j, v_j = jrk.probe_rank_pallas(cfg, jnp.asarray(rows),
                                          jnp.asarray(q.reshape(G, 3 * n)), interpret=True)
    g_t, p_t, v_t = trk.probe_rank(torch.as_tensor(rows), torch.as_tensor(q), k, L, maxd2)
    np.testing.assert_array_equal(np_(v_t), np_(v_j))
    np.testing.assert_array_equal(np_(g_t), np_(g_j))
    # the kernel also returns the chosen column's xyz for invalid slots
    np.testing.assert_array_equal(np_(p_t), np_(p_j))
    assert np_(v_t).sum() > 0 and (~np_(v_t)).sum() > 0
    g_x, v_x = jax.jit(_xla_rank, static_argnums=(2, 3, 4))(jnp.asarray(rows), jnp.asarray(q),
                                                            k, L, maxd2)
    np.testing.assert_array_equal(np_(g_t), np_(g_x))
    np.testing.assert_array_equal(np_(v_t), np_(v_x))


def test_rank_wrapper_checks():
    rows = torch.zeros((4, 5 * 3))
    q = torch.zeros((4, 1, 3))
    g, p, v = trk.probe_rank(rows, q, 3, 10, 1.0)      # CPU -> plain version
    assert g.shape == (4, 1, 3) and v.dtype == torch.bool
    assert trk.probe_rank.__module__ == "pin_slam_torch.ops.rank_kernel"


# ----------------------------------------------------------------------
# the fused brick probe + rank (probe_rank_brick) against JAX _probe_rank
# ----------------------------------------------------------------------


def _brick_case():
    """A brick-layout (2, 2, 1) local hash with collisions (2^10 brick rows),
    a dense lattice cluster and sparse points at negative coordinates,
    duplicated positions (exact ties), and probe groups near the points,
    beyond the map, and at the dedup filler 1e6 (queries 0 there)."""
    import dataclasses

    from torch_port_util import small_config

    from pin_slam_torch.config import Config as TConfig
    from pin_slam_torch.models import neural_points as tn
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.models import neural_points as jn

    over = dict(map_capacity=1 << 14, local_map_capacity=1 << 10)
    jmc = jn.MapConfig.from_config(small_config(JConfig, **over))
    tmc = tn.MapConfig.from_config(small_config(TConfig, **over))
    jmc, tmc = (dataclasses.replace(m, local_hash_size=1 << 12, max_valid_dist2=0.2)
                for m in (jmc, tmc))
    assert tmc.nsub == 4 and jmc.brick_rows == tmc.brick_rows == 1 << 10
    rng = np.random.default_rng(11)
    L = tmc.local_capacity
    dense = rng.integers(0, 10, size=(640, 3)) * 0.125 - 1.0
    sparse = np.round(rng.uniform(-6, 2, size=(L + 1 - 640, 3)) * 8) / 8
    pos = np.concatenate([dense, sparse]).astype(np.float32)
    pos[700:760] = pos[100:160]                                  # duplicates
    idx = rng.permutation(1 << 14)[:L + 1]
    hash_rows = tn._pack_hash_rows(tmc, torch.as_tensor(pos), torch.tensor(900),
                                   torch.as_tensor(idx))
    G = 64
    probe = (pos[rng.integers(0, 900, G)] + rng.uniform(-0.2, 0.2, (G, 3))).astype(np.float32)
    probe[40:48] -= 30.0                                         # beyond the map
    probe[56:] = 1e6                                             # dedup fillers
    return jmc, tmc, jn, tn, hash_rows, probe, rng


@pytest.mark.parametrize("n,k", [(1, 1), (1, 6), (4, 1), (4, 6), (5, 1), (5, 6)])
@pytest.mark.parametrize("use_rank_kernel", [False, True], ids=["xla", "pallas"])
def test_probe_rank_brick_matches_jax(use_rank_kernel, n, k):
    """probe_rank_brick's plain version (what the port runs on the CPU and
    what chip_smoke holds the CUDA kernel to) against jitted JAX
    ``_probe_rank`` in brick mode, through its XLA branch and through the
    Pallas kernel in interpret mode: gidx, valid and pos exact."""
    from pin_slam_torch.slam import mapper as tmp
    from pin_slam_tpu.slam import mapper as jmp

    jmc, tmc, jn, tn, hash_rows, probe, rng = _brick_case()
    G = probe.shape[0]
    q = (probe[:, None, :] + rng.uniform(-0.4, 0.4, (G, n, 3))).astype(np.float32)
    q[56:] = 0.0
    cfg = (tmc.voxel_size, tmc.local_capacity)
    jt = jn.make_probe_template(jmc, 2, 0.2)
    tt = tn.make_probe_template(tmc, 2, 0.2)
    jlm = jn.init_local_map(jmc)._replace(hash_rows=jnp.asarray(np_(hash_rows)))
    run = jax.jit(jmp._probe_rank, static_argnums=(1, 5, 6))
    g_j, p_j, v_j = run(jlm, jmc, jt, jnp.asarray(probe), jnp.asarray(q), k, use_rank_kernel)
    tp, tq = torch.as_tensor(probe), torch.as_tensor(q)
    out = trk.probe_rank_brick_plain(hash_rows, tt.bricks, tt.memb, tp, tq, k, cfg[1],
                                     tmc.max_valid_dist2, cfg[0], tmc.brick, tmc.brick_rows)
    np.testing.assert_array_equal(np_(out[2]), np_(v_j))
    np.testing.assert_array_equal(np_(out[0]), np_(g_j))
    np.testing.assert_array_equal(np_(out[1]), np_(p_j))
    # the mapper's brick path goes through the wrapper, on the CPU to the same plain version
    tlm = tn.init_local_map(tmc)
    tlm.hash_rows = hash_rows
    for a, b in zip(tmp._probe_rank(tlm, tmc, tt, tp, tq, k), out):
        assert torch.equal(a, b)
    v = np_(out[2]).sum(-1)
    assert (v == k).any() and (v == 0).any()
    if k == 6:
        assert ((v > 0) & (v < k)).any()                         # exhausted balls


def _brick_args(dev="cpu", **over):
    """Valid probe_rank_brick arguments at a tiny size, with ``over``
    replacing some."""
    Hb, Kb, G, n = 8, 3, 5, 2
    a = dict(hash_rows=torch.zeros(((Hb + 1) * 4, 5)),
             bricks=torch.zeros((4, Kb, 3), dtype=torch.int32),
             memb=torch.ones((4, Kb * 4)), probe_pts=torch.zeros((G, 3)),
             queries=torch.zeros((G, n, 3)), k=3, L=10, max_valid_dist2=1.0,
             voxel_size=0.5, brick=(2, 2, 1), Hb=Hb)
    a.update(over)
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v(dev) if callable(v) else v
            for k, v in a.items()}


_BAD = {
    "table_dtype": dict(hash_rows=torch.zeros((36, 5), dtype=torch.float64)),
    "table_size": dict(hash_rows=torch.zeros((32, 5))),
    "bricks_dtype": dict(bricks=torch.zeros((4, 3, 3), dtype=torch.int64)),
    "bricks_shape": dict(bricks=torch.zeros((2, 3, 3), dtype=torch.int32)),
    "memb_shape": dict(memb=torch.ones((4, 3))),
    "probe_shape": dict(probe_pts=torch.zeros((5, 2))),
    "probe_strided": dict(probe_pts=lambda dev: torch.zeros((5, 6), device=dev)[:, ::2]),
    "queries_groups": dict(queries=torch.zeros((4, 2, 3))),
    "queries_dtype": dict(queries=torch.zeros((5, 2, 3), dtype=torch.float16)),
    "k_zero": dict(k=0),
    "k_above_Kc": dict(k=13),
    "k_above_max": dict(bricks=torch.zeros((4, 8, 3), dtype=torch.int32),
                        memb=torch.ones((4, 32)), k=17),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_probe_rank_brick_refuses_bad_inputs_before_the_device_branch(bad):
    """The wrapper's checks come before it looks at the device: a bad dtype
    or shape raises the same error on the CPU as on another device (here
    ``meta``, where no kernel and no plain version can run)."""
    errs = []
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError) as e:
            trk.probe_rank_brick(**_brick_args(dev, **_BAD[bad]))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_probe_rank_brick_wrapper_devices_and_views():
    """Valid inputs: the CPU takes the plain version; a device that is
    neither CPU nor CUDA, or tensors on two devices, are refused; row-strided
    probe and query views (the mapper passes slices of the ray samples) give
    the same result as contiguous copies."""
    out = trk.probe_rank_brick(**_brick_args())
    assert [tuple(t.shape) for t in out] == [(5, 2, 3), (5, 2, 3, 3), (5, 2, 3)]
    assert out[0].dtype == torch.int32 and out[2].dtype == torch.bool
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        trk.probe_rank_brick(**_brick_args("meta"))
    mixed = _brick_args()
    mixed["queries"] = mixed["queries"].to("meta")
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        trk.probe_rank_brick(**mixed)
    jmc, tmc, jn, tn, hash_rows, probe, rng = _brick_case()
    tt = tn.make_probe_template(tmc, 2, 0.5)
    samples = torch.as_tensor(probe[:, None, :] + rng.uniform(-0.3, 0.3, (64, 7, 3))
                              .astype(np.float32))
    common = (6, tmc.local_capacity, tmc.max_valid_dist2, tmc.voxel_size, tmc.brick,
              tmc.brick_rows)
    views = trk.probe_rank_brick(hash_rows, tt.bricks, tt.memb, samples[:, 0],
                                 samples[:, 1:5], *common)
    copies = trk.probe_rank_brick(hash_rows, tt.bricks, tt.memb, samples[:, 0].contiguous(),
                                  samples[:, 1:5].contiguous(), *common)
    for a, b in zip(views, copies):
        assert torch.equal(a, b)
    assert tt.memb.shape[1] == 128


def test_probe_rank_refuses_identically_on_cpu_and_meta():
    """The per-cell wrapper's checks also precede its device branch."""
    for rows, q, k in ((torch.zeros((4, 15), dtype=torch.float64), torch.zeros((4, 1, 3)), 3),
                       (torch.zeros((4, 14)), torch.zeros((4, 1, 3)), 3),
                       (torch.zeros((4, 15)), torch.zeros((4, 1, 3)), 4)):
        errs = []
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError) as e:
                trk.probe_rank(rows.to(dev), q.to(dev), k, 10, 1.0)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
