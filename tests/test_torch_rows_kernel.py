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


def _loop_sum(base, idx, val, skip_row=None):
    """The explicit sequential in-order float32 scatter-add."""
    ref = base.copy()
    for m in range(len(idx)):
        if idx[m] != skip_row:
            ref[idx[m]] = (ref[idx[m]] + val[m]).astype(np.float32)
    return ref


def _ordered_case(case):
    """(base, idx, val, skip_row) of a reference case: a sentinel row with a
    long skipped segment, rows with no contribution, one row with 60, and a
    row fed only -0.0 terms."""
    rng = np.random.default_rng(21)
    N, C, M = 40, 5, 400
    idx = rng.integers(0, N // 2, size=M).astype(np.int64)     # rows N/2.. stay empty
    idx[rng.permutation(M)[:60]] = 7                            # a 60-term segment
    idx[rng.random(M) < 0.2] = N - 1                            # the sentinel
    val = rng.standard_normal((M, C)).astype(np.float32)
    idx[::37] = 3
    val[idx == 3] = -0.0
    base = (np.zeros((N, C), np.float32) if case == "zero_base"
            else rng.standard_normal((N, C)).astype(np.float32))
    return base, idx, val, (N - 1 if case == "skip" else None)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("case", ["skip", "all_rows", "zero_base"])
def test_ordered_reference_has_the_sequential_bits(case):
    """scatter_add_rows_ordered (level by level, the card's reference) has
    the bits of the plain version and of the explicit in-order float32 loop:
    skipped sentinel, empty rows, a 60-term segment, -0.0 terms (+0.0 on a
    zero base)."""
    base, idx, val, skip = _ordered_case(case)
    assert np.bincount(idx, minlength=base.shape[0])[7] >= 50
    t, i, v = (torch.as_tensor(a) for a in (base, idx, val))
    out = rows.scatter_add_rows_ordered(t, i, v, skip)
    np.testing.assert_array_equal(_bits(out), _bits(_loop_sum(base, idx, val, skip)))
    np.testing.assert_array_equal(_bits(out), _bits(rows.scatter_add_rows_plain(t, i, v, skip)))
    if case == "zero_base":
        assert not torch.signbit(out[3]).any()                  # 0 + (-0.0) is +0.0
    if skip is not None:
        assert torch.equal(out[skip], t[skip])


@pytest.mark.parametrize("skip", [True, False], ids=["skip_sentinel", "all_rows"])
def test_scatter_sum_rows_is_the_scatter_onto_zeros(skip):
    """The zero-base entry equals scatter_add_rows_plain onto a zero table
    bit for bit (signed zeros included), with a plan or without, and reads
    no table."""
    _, idx, val, _ = _ordered_case("zero_base")
    N = 40
    skip_row = N - 1 if skip else None
    i, v = torch.as_tensor(idx), torch.as_tensor(val)
    ref = rows.scatter_add_rows_plain(torch.zeros(N, 5), i, v, skip_row)
    for plan in (None, rows.scatter_plans(i, N)):
        out = rows.scatter_sum_rows(N, i, v, plan=plan, skip_row=skip_row)
        assert out.shape == (N, 5) and out.dtype == torch.float32
        np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert not torch.signbit(out[3]).any()


def test_scatter_plans_are_int32_with_the_int64_values():
    """The plans are int32 and hold the values the int64 plans held: the
    stable argsort and the cumulative segment counts."""
    rng = np.random.default_rng(4)
    N, T, M = 37, 3, 200
    idx = rng.integers(0, N, size=(T, M)).astype(np.int64)
    plans = rows.scatter_plans(torch.as_tensor(idx), N)
    assert plans.order.dtype == plans.offsets.dtype == torch.int32
    for t in range(T):
        p = rows.plan_at(plans, t)
        np.testing.assert_array_equal(p.order.numpy().astype(np.int64),
                                      np.argsort(idx[t], kind="stable"))
        np.testing.assert_array_equal(
            p.offsets.numpy().astype(np.int64),
            np.concatenate([[0], np.cumsum(np.bincount(idx[t], minlength=N))]))


def test_scatter_plans_raise_past_int32_and_take_no_indices():
    """A plan that int32 cannot hold raises (nothing is truncated); M = 0
    gives empty plans, and both forms then return their base."""
    with pytest.raises(ValueError, match="int32"):
        rows.scatter_plans(torch.zeros((3, 5), dtype=torch.int64), 2 ** 30)
    with pytest.raises(ValueError, match="int32"):
        rows.scatter_plans(torch.zeros((2, 5), dtype=torch.int64), 2 ** 31 - 1)
    empty = torch.zeros(0, dtype=torch.int64)
    p = rows.scatter_plans(empty, 6)
    assert p.order.shape == (0,) and torch.equal(p.offsets, torch.zeros(7, dtype=torch.int32))
    assert rows.scatter_plans(empty.view(2, 0), 6).offsets.shape == (2, 7)
    v = torch.zeros(0, 4)
    assert torch.equal(rows.scatter_sum_rows(6, empty, v, plan=p), torch.zeros(6, 4))
    t = torch.randn(6, 4)
    assert torch.equal(rows.scatter_add_rows(t, empty, v, plan=p), t)


def test_scatter_sum_rows_raises_on_bad_inputs():
    _, idx, val, _ = _ordered_case("zero_base")
    i, v = torch.as_tensor(idx), torch.as_tensor(val)
    plan = rows.scatter_plans(i, 40)
    with pytest.raises(TypeError):
        rows.scatter_sum_rows(40, i.to(torch.int32), v)
    with pytest.raises(ValueError):
        rows.scatter_sum_rows(40, i, v.double())
    with pytest.raises(ValueError):
        rows.scatter_sum_rows(40, i, v[:-1])
    with pytest.raises(IndexError):
        rows.scatter_sum_rows(40, i, v, skip_row=40)
    with pytest.raises(IndexError):
        rows.scatter_sum_rows(20, i, v)
    int64_plan = rows.ScatterPlan(order=plan.order.long(), offsets=plan.offsets.long())
    for bad in (int64_plan, rows.scatter_plans(i, 41)):
        with pytest.raises(ValueError, match="plan"):
            rows.scatter_sum_rows(40, i, v, plan=bad)
        with pytest.raises(ValueError, match="plan"):
            rows.scatter_add_rows(torch.zeros(40, 5), i, v, plan=bad)
