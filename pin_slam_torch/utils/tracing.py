"""The port's one place of measurement: spans and counted host syncs,
gathered into a report for each frame.

- ``span(name)``: a context named ``pin_slam.<stage>[.<part>]``.  It always
  adds its host milliseconds (``time.perf_counter``, the clock the
  profiler's host events use) to the current report's ``span_ms[name]``.
  Only while ``torch.profiler`` records does it also open a
  ``record_function(name)`` range, so that a trace can put each device op
  and each idle gap down to the innermost program span around it; with no
  profiler it enters no ``record_function``.  ``part(name)`` is the span
  ``pin_slam.<current stage>.<name>``, for code that runs in more than one
  stage (the tracker runs in odometry and in loop verification).
- ``read(x, site[, conv])``: every blocking device-to-host read of the
  main path goes through it (``x.cpu()``, or ``conv(x)`` for ``int`` /
  ``bool`` / ``float`` / ``.tolist()`` of a device tensor); ``upload`` is
  its twin for a blocking host-to-device copy, and ``call`` for a torch
  call that synchronises inside (a data-dependent output shape: ``nonzero``
  once, ``bincount`` twice).  Each counts ``sync.<stage>.<site>``, adds the
  host milliseconds it blocked to ``wait_ms`` under the same key, and
  returns exactly what the bare call returns.  The site is counted on every
  device, so that the counts on the CPU show the structure the card pays
  for.
- ``stage_sync(device)``: the synchronise a ``sync_stages`` run makes at
  each stage's end, counted apart as ``sync.stage``, its wait under
  ``wait_ms["stage.<stage>"]``.
- ``count(key, n)``: adds ``n`` to ``counts[key]``, a count of work that is
  no sync (``ba.iters``): such keys never start with ``sync.``.

The stage of a sync or a wait is that of the innermost open span (``frame``
outside every stage span).  ``frame(frame_id)`` opens the ``pin_slam.frame``
span and a fresh report, which takes over from what was measured since the
last frame closed only the ``dataset`` stage's entries (the dataset's
``preprocess_frame`` of this frame) and drops the rest (a system's
construction, end-of-run artifacts); the report, returned by
``SlamSystem.process_frame`` as ``info["trace"]``, is

    {"frame_id", "span_ms": {span: ms}, "counts": {key: n},
     "wait_ms": {key: ms}, "launches": {kernel: n}}

with ``launches`` the frame's deltas of ``ops._cuda.COUNTS`` (the launch
counters of the port's hand-written kernels, which stay where they are).
Without a synchronise a span's milliseconds are host time: what the host
enqueued plus what it waited for in counted reads, not device time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch
from torch.autograd import profiler as _profiler

from pin_slam_torch.ops import _cuda

PREFIX = "pin_slam."
_clock = time.perf_counter


def _new_report(frame_id: Optional[int]) -> dict:
    return {"frame_id": frame_id, "span_ms": {}, "counts": {}, "wait_ms": {}, "launches": {}}


_report = _new_report(None)      # the open frame's, or what runs between frames
_stages = []                     # the stage of every open span, innermost last


def _stage() -> str:
    return _stages[-1] if _stages else "frame"


def _add(table: Dict, key: str, v) -> None:
    table[key] = table.get(key, 0) + v


class span:
    """``with span("pin_slam.odometry"):`` (see the module's docstring);
    ``ms`` holds the interval's host milliseconds once it has closed."""

    __slots__ = ("name", "stage", "ms", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.stage = name.split(".", 2)[1]
        self.ms = 0.0

    def __enter__(self):
        _stages.append(self.stage)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.ms = (_clock() - self._t0) * 1e3
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stages.pop()
        _add(_report["span_ms"], self.name, self.ms)
        return False


def part(name: str) -> span:
    """The span ``pin_slam.<innermost open stage>.<name>``."""
    return span(f"{PREFIX}{_stage()}.{name}")


def _blocked(site: str, t0: float, syncs: int = 1) -> None:
    key = f"sync.{_stage()}.{site}"
    _add(_report["counts"], key, syncs)
    _add(_report["wait_ms"], key, (_clock() - t0) * 1e3)


def read(x: torch.Tensor, site: str, conv: Optional[Callable] = None):
    """``x.cpu()``, or ``conv(x)``, counted as one host sync at ``site``."""
    t0 = _clock()
    out = x.cpu() if conv is None else conv(x)
    _blocked(site, t0)
    return out


def upload(x, site: str, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``: a blocking
    host-to-device copy, counted as one host sync at ``site``.  A tensor
    already on an accelerator passes uncounted: nothing leaves the host."""
    if isinstance(x, torch.Tensor) and not x.is_cpu:
        return torch.as_tensor(x, dtype=dtype, device=device)
    t0 = _clock()
    out = torch.as_tensor(x, dtype=dtype, device=device)
    _blocked(site, t0)
    return out


def call(fn: Callable, site: str, *args, syncs: int = 1, **kwargs):
    """``fn(*args, **kwargs)``, a torch call that synchronises ``syncs``
    times inside (its output's shape depends on the data), counted at
    ``site``."""
    t0 = _clock()
    out = fn(*args, **kwargs)
    _blocked(site, t0, syncs)
    return out


def count(key: str, n: int) -> None:
    """Adds ``n`` to the current report's ``counts[key]``."""
    _add(_report["counts"], key, n)


def stage_sync(device) -> None:
    """The ``sync_stages`` synchronise at a stage's end."""
    t0 = _clock()
    torch.cuda.synchronize(device)
    _add(_report["counts"], "sync.stage", 1)
    _add(_report["wait_ms"], f"stage.{_stage()}", (_clock() - t0) * 1e3)


class frame:
    """``with frame(frame_id) as report:``: the ``pin_slam.frame`` span and
    the frame's report (see the module's docstring)."""

    __slots__ = ("report", "_span", "_launches")

    def __init__(self, frame_id: int):
        self.report = _new_report(int(frame_id))
        self._span = span(PREFIX + "frame")

    def __enter__(self) -> dict:
        global _report
        for key in ("span_ms", "counts", "wait_ms"):
            self.report[key].update((k, v) for k, v in _report[key].items()
                                    if k.split(".", 2)[1] == "dataset")
        _report = self.report
        self._launches = dict(_cuda.COUNTS)
        self._span.__enter__()
        return self.report

    def __exit__(self, *exc):
        global _report
        self._span.__exit__(*exc)
        before = self._launches
        self.report["launches"] = {k: n - before.get(k, 0) for k, n in _cuda.COUNTS.items()
                                   if n != before.get(k, 0)}
        _report = _new_report(None)
        return False
