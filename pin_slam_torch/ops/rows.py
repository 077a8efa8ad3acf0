"""Row gather and deterministic row scatter-add: the CUDA kernels of
``csrc/rows.cu`` and their plain PyTorch twins.  Counterparts of the JAX
package's two Pallas primitives ``make_gather_kernel`` and
``make_scatter_kernel`` (``experiments/profile_pallas_gather.py``), whose
bodies are ``jnp.take(tab, ix, axis=0)`` and ``tab.at[ix].add(val)``.

On the main path these are the training loop's pool-row gather, its
per-iteration feature-row gather and its row-gradient scatter
(``slam/mapper.py:mapping_loop_cached``).  Bundle adjustment differentiates
through the feature gather with torch autograd: ``GatherRowsFn`` runs the
gather kernel forward and the deterministic scatter backward, where plain
autograd of ``table[idx]`` would add with float atomics.

The scatter adds without float atomics: ``scatter_plans`` sorts each
iteration's destination indices once (stable, so equal destinations keep
their original order) and counts the segment of every destination row, in
int32; the kernel then sums each row's contributions in that order.
Launches are bit-identical to one another and to a sequential in-order
``index_add``.  The plans of all iterations of a frame are built in one
call, outside the kernel, because the training loop knows every iteration's
indices up front.  The training loop sums into a zero table
(``scatter_sum_rows``, which reads none); ``scatter_add_rows`` is the Pallas
function's own form, ``tab.at[idx].add(val)``.  ``scatter_add_rows_ordered``
computes the same bits in plain PyTorch on any device, the card included.

Indices are int64 and are range-checked by the wrappers (one host
synchronisation per check); an out-of-range index raises, it is never
clamped.  A caller that has checked a whole frame's indices at once passes
``bounds_checked=True`` (or a plan, which ``scatter_plans`` checked).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pin_slam_torch.ops import _cuda
from pin_slam_torch.utils import tracing


class ScatterPlan(NamedTuple):
    """Destination-sorted order of a scatter's indices: segment r (the
    contributions to row r) is ``order[offsets[r]:offsets[r + 1]]``.  Leading
    dimensions, when present, index the iterations (``scatter_plans``)."""
    order: torch.Tensor      # (..., M) int32
    offsets: torch.Tensor    # (..., N + 1) int32


def plan_at(plans: ScatterPlan, t: int) -> ScatterPlan:
    """The plan of iteration ``t`` of a batched plan."""
    return ScatterPlan(order=plans.order[t], offsets=plans.offsets[t])


def check_index(idx: torch.Tensor, n_rows: int) -> None:
    """Raise unless ``idx`` is int64 with every value in [0, n_rows)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"row indices must be int64, got {idx.dtype}")
    if idx.numel():
        lo, hi = (tracing.read(v, "check_index", int) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n_rows:
            raise IndexError(f"row index out of range [0, {n_rows}): min {lo}, max {hi}")


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("row kernels take a contiguous float32 (N, C) table, got "
                         f"{tuple(table.shape)} {table.dtype}")


def _check_idx(idx: torch.Tensor, table: torch.Tensor) -> None:
    if idx.dtype != torch.int64:
        raise TypeError(f"row indices must be int64, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.get_device() != table.get_device():
        raise ValueError(f"row indices must be a contiguous (M,) tensor on the table's "
                         f"device, got {tuple(idx.shape)} on {idx.device}")


_GATHER_ARGS = [_cuda.P, _cuda.P, _cuda.I64, _cuda.I64, _cuda.I, _cuda.P, _cuda.P]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                bounds_checked: bool = False) -> torch.Tensor:
    """(M, C) rows ``table[idx]``.  CPU tensors take the plain version, CUDA
    tensors launch ``gather_rows_kernel`` (none for M = 0).  The checks read
    only dtypes, shapes and strides, so the launch path costs about what one
    PyTorch operator's does."""
    _check_table(table)
    _check_idx(idx, table)
    if not bounds_checked:
        check_index(idx, table.shape[0])
    if table.is_cpu:
        return gather_rows_plain(table, idx)
    (N, C), M = table.shape, idx.shape[0]
    out = table.new_empty((M, C))
    if M:
        f = _cuda.fn("rows", "gather_rows_launch", _GATHER_ARGS)
        _cuda.check(f(table.data_ptr(), idx.data_ptr(), N, M, C, out.data_ptr(),
                      _cuda.stream_ptr(table.get_device())), "gather_rows_kernel")
        _cuda.COUNTS["gather"] += 1
    return out


_I32_MAX = 2 ** 31 - 1


def scatter_plans(idx: torch.Tensor, n_rows: int) -> ScatterPlan:
    """Plans of a scatter into ``n_rows`` rows for ``idx`` (M,) or for each
    row of ``idx`` (T, M): one stable sort of int32 destination keys shifted
    by ``t * n_rows`` and one integer ``bincount`` (both deterministic), in
    int32.  Raises where T * (n_rows + 1) or T * M does not fit int32."""
    check_index(idx, n_rows)
    dev = idx.device
    T, M = (1, idx.shape[0]) if idx.dim() == 1 else idx.shape
    idx2 = idx.reshape(T, M)
    if T * (n_rows + 1) > _I32_MAX or T * M > _I32_MAX:
        raise ValueError(f"scatter plans of {T} x {M} indices into {n_rows} rows do not fit "
                         f"int32")
    it = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    key = (idx2.to(torch.int32) + it * n_rows).reshape(-1)
    order = torch.sort(key, stable=True).indices.to(torch.int32).view(T, M) - it * M
    # bincount reads the keys' min and max on the host: two syncs
    counts = tracing.call(torch.bincount, "bincount", key, minlength=T * n_rows,
                          syncs=2).view(T, n_rows)
    offsets = torch.zeros((T, n_rows + 1), dtype=torch.int32, device=dev)
    offsets[:, 1:] = torch.cumsum(counts, 1, dtype=torch.int32)
    if idx.dim() == 1:
        return ScatterPlan(order=order[0], offsets=offsets[0])
    return ScatterPlan(order=order, offsets=offsets)


def scatter_add_rows_plain(table: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                           skip_row: Optional[int] = None) -> torch.Tensor:
    """``table.index_add(0, idx, val)`` (sequential on the CPU), leaving out
    the contributions to ``skip_row``."""
    if skip_row is not None:
        keep = idx != skip_row
        idx, val = idx[keep], val[keep]
    return table.index_add(0, idx, val)


def scatter_add_rows_ordered(table: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                             skip_row: Optional[int] = None) -> torch.Tensor:
    """``scatter_add_rows_plain``'s bits on any device: level p adds every
    row's p-th contribution (in index order) to the row's running sum, one
    float32 add per element, for as many levels as the longest segment that
    is not skipped.  Each element is the same chain of float32 additions as a
    sequential in-order ``index_add``, so the card's result is the CPU's.
    The reference of the scatter kernel's bits on the card."""
    keep = torch.ones_like(idx, dtype=torch.bool) if skip_row is None else idx != skip_row
    pos = torch.nonzero(keep).reshape(-1)
    dest = idx[pos]
    order = pos[torch.sort(dest, stable=True).indices]
    counts = torch.bincount(dest, minlength=table.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    out = table.clone()
    for p in range(int(counts.max()) if dest.numel() else 0):
        rows = torch.nonzero(counts > p).reshape(-1)
        out[rows] = out[rows] + val[order[starts[rows] + p]]
    return out


def _check_scatter(N: int, C: int, idx: torch.Tensor, val: torch.Tensor,
                   plan: Optional[ScatterPlan], skip_row: Optional[int],
                   device: torch.device) -> None:
    if idx.dtype != torch.int64:
        raise TypeError(f"row indices must be int64, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.device != device:
        raise ValueError(f"row indices must be a contiguous (M,) tensor on {device}, got "
                         f"{tuple(idx.shape)} on {idx.device}")
    if val.shape != (idx.shape[0], C) or val.dtype != torch.float32 \
            or not val.is_contiguous() or val.device != device:
        raise ValueError(f"values must be a contiguous float32 ({idx.shape[0]}, {C}) tensor "
                         f"on {device}, got {tuple(val.shape)} {val.dtype}")
    if skip_row is not None and not 0 <= skip_row < N:
        raise IndexError(f"skip_row {skip_row} outside [0, {N})")
    if plan is not None and (plan.order.shape != idx.shape
                             or plan.offsets.shape != (N + 1,)
                             or plan.order.dtype != torch.int32
                             or plan.offsets.dtype != torch.int32
                             or not plan.order.is_contiguous()
                             or not plan.offsets.is_contiguous()
                             or plan.order.device != device
                             or plan.offsets.device != device):
        raise ValueError(f"plan of order {tuple(plan.order.shape)} {plan.order.dtype} / "
                         f"offsets {tuple(plan.offsets.shape)} {plan.offsets.dtype} does not "
                         f"fit idx {tuple(idx.shape)} and {N} rows (contiguous int32 on "
                         f"{device})")


_SCATTER_ARGS = [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I, _cuda.I64,
                 _cuda.I64, _cuda.P, _cuda.P]


def _launch_scatter(table: Optional[torch.Tensor], N: int, idx: torch.Tensor,
                    val: torch.Tensor, plan: Optional[ScatterPlan],
                    skip_row: Optional[int]) -> torch.Tensor:
    """One launch of ``scatter_rows_kernel``: onto ``table``, or from zeros
    where it is None."""
    if plan is None:
        plan = scatter_plans(idx, N)
    out = val.new_empty((N, val.shape[1]))
    f = _cuda.fn("rows", "scatter_rows_launch", _SCATTER_ARGS)
    _cuda.check(f(None if table is None else table.data_ptr(), val.data_ptr(),
                  plan.order.data_ptr(), plan.offsets.data_ptr(), N, val.shape[1],
                  val.shape[0], -1 if skip_row is None else int(skip_row), out.data_ptr(),
                  _cuda.stream_ptr(val.device)), "scatter_rows_kernel")
    _cuda.COUNTS["scatter"] += 1
    return out


def scatter_add_rows(table: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                     plan: Optional[ScatterPlan] = None,
                     skip_row: Optional[int] = None) -> torch.Tensor:
    """table + the rows of ``val`` added at ``idx``, as a new tensor.  Row
    ``skip_row`` (if given) receives nothing.  ``plan`` is the
    ``scatter_plans`` plan of ``idx`` (built here when absent).  CPU tensors
    take the plain version, CUDA tensors launch ``scatter_rows_kernel``."""
    _check_table(table)
    N, C = table.shape
    _check_scatter(N, C, idx, val, plan, skip_row, table.device)
    if table.device.type == "cpu":
        if plan is None:
            check_index(idx, N)
        return scatter_add_rows_plain(table, idx, val, skip_row)
    return _launch_scatter(table, N, idx, val, plan, skip_row)


def scatter_sum_rows(n_rows: int, idx: torch.Tensor, val: torch.Tensor,
                     plan: Optional[ScatterPlan] = None,
                     skip_row: Optional[int] = None) -> torch.Tensor:
    """The (n_rows, C) table of the rows of ``val`` summed at ``idx``, each
    row in index order from +0.0: ``scatter_add_rows`` onto a zero table, bit
    for bit, with no table made or read.  Row ``skip_row`` (if given) is 0.
    CPU tensors take the plain version, CUDA tensors launch
    ``scatter_rows_kernel``'s zero-base form."""
    _check_scatter(n_rows, val.shape[-1], idx, val, plan, skip_row, val.device)
    if val.device.type == "cpu":
        if plan is None:
            check_index(idx, n_rows)
        return scatter_add_rows_plain(val.new_zeros((n_rows, val.shape[1])), idx, val,
                                      skip_row)
    return _launch_scatter(None, n_rows, idx, val, plan, skip_row)


class GatherRowsFn(torch.autograd.Function):
    """``table[idx]`` for any shape of int64 ``idx`` (rows (*idx.shape, C)),
    differentiable in ``table``: forward the row-gather kernel, backward the
    zero-base scatter of the output gradient into (N, C) rows, each row
    summed in index order (a plan built for this call's indices), so the
    gradient has a sequential in-order ``index_add``'s bits on every device.
    Row ``skip_row`` (if not None) gets a zero gradient.  A caller that has
    built the scatter plan of ``idx`` (flattened) passes it as ``plan``; its
    indices were range-checked then, so the forward gather checks none.
    CPU tensors take the plain versions, as the wrappers do."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor,
                skip_row: Optional[int] = None,
                plan: Optional[ScatterPlan] = None) -> torch.Tensor:
        flat = idx.reshape(-1).contiguous()
        ctx.save_for_backward(flat)
        ctx.n_rows, ctx.skip_row, ctx.plan = table.shape[0], skip_row, plan
        return gather_rows(table, flat, bounds_checked=plan is not None).view(
            *idx.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (flat,) = ctx.saved_tensors
        g = grad_out.reshape(flat.shape[0], -1).contiguous()
        return (scatter_sum_rows(ctx.n_rows, flat, g, plan=ctx.plan, skip_row=ctx.skip_row),
                None, None, None)
