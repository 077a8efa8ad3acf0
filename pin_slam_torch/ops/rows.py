"""Row gather and deterministic row scatter-add: the CUDA kernels of
``csrc/rows.cu`` and their plain PyTorch twins.  Counterparts of the JAX
package's two Pallas primitives ``make_gather_kernel`` and
``make_scatter_kernel`` (``experiments/profile_pallas_gather.py``), whose
bodies are ``jnp.take(tab, ix, axis=0)`` and ``tab.at[ix].add(val)``.

On the main path these are the training loop's pool-row gather, its
per-iteration feature-row gather and its row-gradient scatter
(``slam/mapper.py:mapping_loop_cached``).

The scatter adds without float atomics: ``scatter_plans`` sorts each
iteration's destination indices once (stable, so equal destinations keep
their original order) and counts the segment of every destination row; the
kernel then sums each row's contributions in that order.  Launches are
bit-identical to one another and to a sequential in-order ``index_add``.
The plans of all iterations of a frame are built in one call, outside the
kernel, because the training loop knows every iteration's indices up front.

Indices are int64 and are range-checked by the wrappers (one host
synchronisation per check); an out-of-range index raises, it is never
clamped.  A caller that has checked a whole frame's indices at once passes
``bounds_checked=True`` (or a plan, which ``scatter_plans`` checked).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pin_slam_torch.ops import _cuda


class ScatterPlan(NamedTuple):
    """Destination-sorted order of a scatter's indices: segment r (the
    contributions to row r) is ``order[offsets[r]:offsets[r + 1]]``.  Leading
    dimensions, when present, index the iterations (``scatter_plans``)."""
    order: torch.Tensor      # (..., M) int64
    offsets: torch.Tensor    # (..., N + 1) int64


def plan_at(plans: ScatterPlan, t: int) -> ScatterPlan:
    """The plan of iteration ``t`` of a batched plan."""
    return ScatterPlan(order=plans.order[t], offsets=plans.offsets[t])


def check_index(idx: torch.Tensor, n_rows: int) -> None:
    """Raise unless ``idx`` is int64 with every value in [0, n_rows)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"row indices must be int64, got {idx.dtype}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= n_rows:
            raise IndexError(f"row index out of range [0, {n_rows}): min {lo}, max {hi}")


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("row kernels take a contiguous float32 (N, C) table, got "
                         f"{tuple(table.shape)} {table.dtype}")


def _check_idx(idx: torch.Tensor, table: torch.Tensor) -> None:
    if idx.dtype != torch.int64:
        raise TypeError(f"row indices must be int64, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous() or idx.device != table.device:
        raise ValueError(f"row indices must be a contiguous (M,) tensor on the table's "
                         f"device, got {tuple(idx.shape)} on {idx.device}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                bounds_checked: bool = False) -> torch.Tensor:
    """(M, C) rows ``table[idx]``.  CPU tensors take the plain version, CUDA
    tensors launch ``gather_rows_kernel``."""
    _check_table(table)
    _check_idx(idx, table)
    if not bounds_checked:
        check_index(idx, table.shape[0])
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    M, C = idx.shape[0], table.shape[1]
    out = torch.empty((M, C), dtype=torch.float32, device=table.device)
    f = _cuda.fn("rows", "gather_rows_launch",
                 [_cuda.P, _cuda.P, _cuda.I64, _cuda.I, _cuda.P, _cuda.P])
    _cuda.check(f(table.data_ptr(), idx.data_ptr(), M, C, out.data_ptr(),
                  _cuda.stream_ptr(table.device)), "gather_rows_kernel")
    _cuda.COUNTS["gather"] += 1
    return out


def scatter_plans(idx: torch.Tensor, n_rows: int) -> ScatterPlan:
    """Plans of a scatter into ``n_rows`` rows for ``idx`` (M,) or for each
    row of ``idx`` (T, M): one stable sort of destination keys shifted by
    ``t * n_rows`` and one integer ``bincount`` (both deterministic)."""
    check_index(idx, n_rows)
    dev = idx.device
    idx2 = idx.reshape(-1, idx.shape[-1])
    T, M = idx2.shape
    it = torch.arange(T, dtype=torch.int64, device=dev)[:, None]
    key = (idx2 + it * n_rows).reshape(-1)
    order = torch.sort(key, stable=True).indices.view(T, M) - it * M
    counts = torch.bincount(key, minlength=T * n_rows).view(T, n_rows)
    offsets = torch.zeros((T, n_rows + 1), dtype=torch.int64, device=dev)
    offsets[:, 1:] = torch.cumsum(counts, 1)
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


def scatter_add_rows(table: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                     plan: Optional[ScatterPlan] = None,
                     skip_row: Optional[int] = None) -> torch.Tensor:
    """table + the rows of ``val`` added at ``idx``, as a new tensor.  Row
    ``skip_row`` (if given) receives nothing.  ``plan`` is the
    ``scatter_plans`` plan of ``idx`` (built here when absent).  CPU tensors
    take the plain version, CUDA tensors launch ``scatter_rows_kernel``."""
    _check_table(table)
    _check_idx(idx, table)
    N, C = table.shape
    if val.shape != (idx.shape[0], C) or val.dtype != torch.float32 \
            or not val.is_contiguous() or val.device != table.device:
        raise ValueError(f"values must be a contiguous float32 ({idx.shape[0]}, {C}) tensor "
                         f"on the table's device, got {tuple(val.shape)} {val.dtype}")
    if skip_row is not None and not 0 <= skip_row < N:
        raise IndexError(f"skip_row {skip_row} outside [0, {N})")
    if plan is not None and (plan.order.shape != idx.shape
                             or plan.offsets.shape != (N + 1,)):
        raise ValueError(f"plan of order {tuple(plan.order.shape)} / offsets "
                         f"{tuple(plan.offsets.shape)} does not fit idx {tuple(idx.shape)} "
                         f"and {N} rows")
    if table.device.type == "cpu":
        if plan is None:
            check_index(idx, N)
        return scatter_add_rows_plain(table, idx, val, skip_row)
    if plan is None:
        plan = scatter_plans(idx, N)
    out = torch.empty_like(table)
    f = _cuda.fn("rows", "scatter_rows_launch",
                 [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64, _cuda.I, _cuda.I64,
                  _cuda.P, _cuda.P])
    _cuda.check(f(table.data_ptr(), val.data_ptr(), plan.order.data_ptr(),
                  plan.offsets.data_ptr(), N, C, -1 if skip_row is None else int(skip_row),
                  out.data_ptr(), _cuda.stream_ptr(table.device)), "scatter_rows_kernel")
    _cuda.COUNTS["scatter"] += 1
    return out
