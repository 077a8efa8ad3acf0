"""The rank kernel's plain twin (what pin_slam_torch runs on the CPU, and
what chip_smoke.py holds the CUDA kernel against on the card) against the
JAX package's Pallas kernel in interpret mode and its XLA branch
(exact_k_min).  Integer outputs must match exactly, ties and exhausted balls
included."""

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
