"""Deterministic static-shape index helpers shared by the port's modules.

The JAX package relies on two XLA idioms that torch has no single call for:

* ``jnp.nonzero(mask, size=n, fill_value=f)``: the first ``n`` true
  positions in order, padded with ``f`` — here a cumsum + scatter, with no
  host synchronisation (``torch.nonzero`` would sync);
* ``table.at[slot].set(rows)`` with repeated slots: the XLA CPU scatter the
  tests compare against applies updates in order, so the LAST writer wins.
  A plain torch ``index_put_`` leaves that order undefined on CUDA; the port
  picks the highest writer index per slot with a deterministic
  ``scatter_reduce(amax)`` and gathers its row.
"""

from __future__ import annotations

import torch

from pin_slam_torch.utils import tracing


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int64 (size,) indices of the first ``size`` true entries of a 1-D mask."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    pos = torch.cumsum(m, 0) - 1
    dest = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def last_writer(slot: torch.Tensor, table_len: int) -> torch.Tensor:
    """For every table slot, the highest index i with slot[i] == slot (or -1)."""
    idx = torch.arange(slot.shape[0], dtype=torch.int64, device=slot.device)
    win = torch.full((table_len,), -1, dtype=torch.int64, device=slot.device)
    return win.scatter_reduce(0, slot, idx, reduce="amax", include_self=True)


def scatter_set_last(table: torch.Tensor, slot: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``table.at[slot].set(rows)`` with in-order (last writer wins) semantics.
    Returns a new tensor; ``table`` is not modified."""
    win = last_writer(slot, table.shape[0])
    hit = tracing.call(torch.nonzero, "set_last", win >= 0)[:, 0]
    out = table.clone()
    out[hit] = rows[win[hit]]
    return out
