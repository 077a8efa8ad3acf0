"""Reductions of a ``torch.profiler`` trace of the traced frames.

Copied in its arithmetic from ``scripts/profile_torch_port.py``
(``gpu_work``, ``kernel_name``, launches matched to their kernels by
correlation id), with the busy time taken as the union of the device
operations' intervals, so that nothing counts twice.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

FRAME_SPAN = "slambench.frame"


def kernel_name(name: str) -> str:
    """'void ns::foo<T>(float const*, ...)' -> 'foo'; a name without that
    shape (a copy, a memset) is returned as it is."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return head[-1].split("::")[-1] if head else name


def _is_device(ev) -> bool:
    import torch

    return ev.device_type == torch.autograd.DeviceType.CUDA


def gpu_work(events, labels: Iterable[str]) -> list:
    """The device-side kernels and copies; the profiler also mirrors every
    record_function range onto the device as a user annotation, which is not
    work."""
    labels = set(labels)
    return [ev for ev in events if _is_device(ev)
            and not getattr(ev, "is_user_annotation", False) and ev.name not in labels]


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def host_spans(events, labels: Iterable[str]):
    """(start, end, name) of the host's record_function ranges named in
    ``labels``."""
    labels = set(labels)
    return [(ev.time_range.start, ev.time_range.end, ev.name) for ev in events
            if not _is_device(ev) and ev.name in labels]


def launch_times(events) -> Dict[int, float]:
    """Correlation id -> host time of the CUDA API call that launched the
    work (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)."""
    out: Dict[int, float] = {}
    for ev in events:
        if not _is_device(ev) and ev.name.startswith("cu"):
            out.setdefault(ev.id, ev.time_range.start)
    return out


class SpanIndex:
    """The host spans of each label, sorted, for lookups by time (the spans
    of one label do not overlap)."""

    def __init__(self, spans):
        import bisect

        self._bisect = bisect.bisect_right
        self.by_label: Dict[str, tuple] = {}
        for name in {s[2] for s in spans}:
            rows = sorted((a, b) for a, b, n in spans if n == name)
            self.by_label[name] = ([a for a, _ in rows], [b for _, b in rows])

    def containing(self, t: float):
        """[(label, start, end)] of the spans that contain time ``t``."""
        out = []
        for name, (starts, ends) in self.by_label.items():
            j = self._bisect(starts, t) - 1
            if j >= 0 and t <= ends[j]:
                out.append((name, starts[j], ends[j]))
        return out

    def innermost(self, t: float, default: str) -> str:
        hit = self.containing(t)
        return min(hit, key=lambda h: h[2] - h[1])[0] if hit else default


def reduce_trace(events, labels: Iterable[str], n_frames: int) -> dict:
    """From the events of ``n_frames`` traced frames, each inside a
    ``FRAME_SPAN`` range: the traced window's length and the device's busy
    seconds in it, the device operations per frame, the top device
    operations by time, the idle seconds by the innermost host span the gap
    fell in, and the device seconds of the work each span launched."""
    labels = list(labels) + [FRAME_SPAN]
    work = gpu_work(events, labels)
    spans = host_spans(events, labels)
    frames = [(a, b) for a, b, name in spans if name == FRAME_SPAN]
    if not frames or not work:
        return {}
    lo, hi = min(a for a, _ in frames), max(b for _, b in frames)
    busy = clip(merge([(ev.time_range.start, ev.time_range.end) for ev in work]), lo, hi)
    busy_us = sum(b - a for a, b in busy)
    by_kernel: Dict[str, float] = {}
    for ev in work:
        key = kernel_name(ev.name)
        by_kernel[key] = by_kernel.get(key, 0.0) + ev.time_range.elapsed_us()
    index = SpanIndex(spans)
    gaps, prev = {}, lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            label = index.innermost(0.5 * (prev + a), "(outside the frames)")
            gaps[label] = gaps.get(label, 0.0) + (a - prev)
        prev = max(prev, b)
    launched = launch_times(events)
    by_span: Dict[str, float] = {}
    for ev in work:
        t = launched.get(ev.id)
        if t is None:
            continue
        for name, _, _ in index.containing(t):
            if name != FRAME_SPAN:
                by_span[name] = by_span.get(name, 0.0) + ev.time_range.elapsed_us() / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": len([ev for ev in work if lo <= ev.time_range.start <= hi]),
            "n_frames": n_frames,
            "top_ops": [[name, us / 1e6] for name, us in top],
            "idle_gaps": [[name, us / 1e6] for name, us in idle],
            "device_s_by_span": by_span}
