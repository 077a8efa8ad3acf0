"""The row gather and row scatter-add of the port (pin_slam_torch.ops.rows):
their plain twins against the bodies of the JAX package's Pallas primitives
(experiments/profile_pallas_gather.py: ``jnp.take(tab, ix, axis=0)`` and
``tab.at[ix].add(val)``; the Pallas kernels themselves use ``pltpu.VMEM`` and
have no CPU interpret path), the wrappers' input checks, the scatter's
destination-sorted plans, and its order determinism."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_torch.ops import rows

torch.set_num_threads(1)


def _inputs(seed, N=4097, C=9, M=6000, skew=True):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=M).astype(np.int64)
    if skew:
        # one long segment, like the training loop's sentinel row
        idx[rng.random(M) < 0.3] = N - 1
    val = rng.standard_normal((M, C)).astype(np.float32)
    return tab, idx, val


@pytest.mark.parametrize("C", [9, 24, 42])
def test_gather_twin_matches_jax_take(C):
    tab, idx, _ = _inputs(0, C=C)
    ref = np.asarray(jax.jit(lambda t, i: jnp.take(t, i, axis=0))(tab, idx.astype(np.int32)))
    out = rows.gather_rows(torch.as_tensor(tab), torch.as_tensor(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("C", [1, 9, 24, 42])
def test_gather_takes_misaligned_views_and_empty_indices(C, offset):
    """A table that is a view off the start of its buffer (the kernel then
    takes its scalar path) gathers like a fresh table, and M = 0 gives an
    empty (0, C) result."""
    tab, idx, _ = _inputs(9, N=301, C=C, M=500)
    buf = torch.zeros(301 * C + offset)
    buf[offset:] = torch.as_tensor(tab).reshape(-1)
    view = buf[offset:].view(301, C)
    ref = np.asarray(jax.jit(lambda t, i: jnp.take(t, i, axis=0))(tab, idx.astype(np.int32)))
    np.testing.assert_array_equal(rows.gather_rows(view, torch.as_tensor(idx)).numpy(), ref)
    empty = rows.gather_rows(view, torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, C) and empty.dtype == torch.float32


def test_cuda_entry_points_resolve_once(monkeypatch):
    """A wrapper's C entry point is looked up and typed on its first call
    only; later calls reuse it."""
    import types

    from pin_slam_torch.ops import _cuda

    looked_up = []

    class FakeLib:
        def __getattr__(self, symbol):
            looked_up.append(symbol)
            return types.SimpleNamespace()

    monkeypatch.setattr(_cuda, "lib", lambda name: FakeLib())
    monkeypatch.setattr(_cuda, "_FNS", {})
    f1 = _cuda.fn("rows", "gather_rows_launch", rows._GATHER_ARGS)
    f2 = _cuda.fn("rows", "gather_rows_launch", rows._GATHER_ARGS)
    assert f1 is f2 and looked_up == ["gather_rows_launch"]
    assert f1.argtypes == rows._GATHER_ARGS and f1.restype is _cuda.ctypes.c_int


def test_scatter_twin_matches_jax_scatter_add():
    """Sum order differs between XLA's scatter and index_add: allclose at
    float32 rounding of a sum of up to ~1800 unit-scale terms."""
    tab, idx, val = _inputs(1)
    ref = np.asarray(jax.jit(lambda t, i, v: t.at[i].add(v))(tab, idx.astype(np.int32), val))
    out = rows.scatter_add_rows(torch.as_tensor(tab), torch.as_tensor(idx), torch.as_tensor(val))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=2e-4)


def test_scatter_skip_row_leaves_other_rows_and_certainty_unchanged():
    """Skipping the sentinel row changes nothing else: every other row, the
    certainty column included, is bit-identical to the full scatter."""
    tab, idx, val = _inputs(2)
    N = tab.shape[0]
    t, i, v = (torch.as_tensor(a) for a in (tab, idx, val))
    full = rows.scatter_add_rows(t, i, v)
    skip = rows.scatter_add_rows(t, i, v, skip_row=N - 1)
    assert torch.equal(skip[:N - 1], full[:N - 1])
    assert torch.equal(skip[:N - 1, -1], full[:N - 1, -1])
    assert torch.equal(skip[N - 1], t[N - 1])


def test_scatter_is_order_deterministic_sequential_sum():
    """The twin adds each row's contributions in index order: bit-identical
    across calls and to an explicit in-order float32 loop."""
    tab, idx, val = _inputs(3, N=50, C=4, M=400)
    t, i, v = (torch.as_tensor(a) for a in (tab, idx, val))
    a = rows.scatter_add_rows(t, i, v, skip_row=49)
    b = rows.scatter_add_rows(t, i, v, skip_row=49)
    assert torch.equal(a, b)
    ref = tab.copy()
    for m in range(len(idx)):
        if idx[m] != 49:
            ref[idx[m]] = (ref[idx[m]] + val[m]).astype(np.float32)
    np.testing.assert_array_equal(a.numpy(), ref)


def test_scatter_plans_sort_stably_and_count_segments():
    rng = np.random.default_rng(4)
    N, T, M = 37, 3, 200
    idx = rng.integers(0, N, size=(T, M)).astype(np.int64)
    plans = rows.scatter_plans(torch.as_tensor(idx), N)
    for t in range(T):
        one = rows.scatter_plans(torch.as_tensor(idx[t]), N)
        p = rows.plan_at(plans, t)
        assert torch.equal(p.order, one.order) and torch.equal(p.offsets, one.offsets)
        np.testing.assert_array_equal(p.order.numpy(), np.argsort(idx[t], kind="stable"))
        np.testing.assert_array_equal(
            p.offsets.numpy(), np.concatenate([[0], np.cumsum(np.bincount(idx[t], minlength=N))]))
        # segment r holds exactly the positions with destination r, in order
        for r in (0, 5, N - 1):
            seg = p.order[p.offsets[r]:p.offsets[r + 1]].numpy()
            np.testing.assert_array_equal(seg, np.nonzero(idx[t] == r)[0])


def test_scatter_with_plan_equals_without():
    tab, idx, val = _inputs(5)
    t, i, v = (torch.as_tensor(a) for a in (tab, idx, val))
    plan = rows.scatter_plans(i, t.shape[0])
    assert torch.equal(rows.scatter_add_rows(t, i, v, plan=plan, skip_row=3),
                       rows.scatter_add_rows(t, i, v, skip_row=3))


@pytest.mark.parametrize("bad", [-1, 4097, 10 ** 6])
def test_wrappers_raise_on_out_of_range_indices(bad):
    tab, idx, val = _inputs(6)
    idx[17] = bad
    t, i, v = (torch.as_tensor(a) for a in (tab, idx, val))
    with pytest.raises(IndexError):
        rows.gather_rows(t, i)
    with pytest.raises(IndexError):
        rows.scatter_add_rows(t, i, v)
    with pytest.raises(IndexError):
        rows.scatter_plans(i, t.shape[0])


def test_wrappers_raise_on_bad_dtypes_and_shapes():
    tab, idx, val = _inputs(7)
    t, i, v = (torch.as_tensor(a) for a in (tab, idx, val))
    with pytest.raises(TypeError):
        rows.gather_rows(t, i.to(torch.int32))
    with pytest.raises(TypeError):
        rows.scatter_add_rows(t, i.to(torch.int32), v)
    with pytest.raises(ValueError):
        rows.gather_rows(t.double(), i)
    with pytest.raises(ValueError):
        rows.gather_rows(t.t(), i)                     # not contiguous
    with pytest.raises(ValueError):
        rows.gather_rows(t, i.reshape(2, -1))
    with pytest.raises(ValueError):
        rows.scatter_add_rows(t, i, v[:, :5].contiguous())
    with pytest.raises(ValueError):
        rows.scatter_add_rows(t, i, v[:-1])
    with pytest.raises(ValueError):
        rows.scatter_add_rows(t, i, v.double())
    with pytest.raises(IndexError):
        rows.scatter_add_rows(t, i, v, skip_row=t.shape[0])
    with pytest.raises(ValueError, match="plan"):
        rows.scatter_add_rows(t, i, v, plan=rows.scatter_plans(i[:-1], t.shape[0]))
