"""The device trace of a traced window, and the benchmark's own spans.

``profiled`` runs a callable under ``torch.profiler`` (CPU and CUDA
activities) twice, keeping the second run: the profiler can lose the
first launches of a window. The kept run's device events (kernels,
copies, sets) and host spans (``torch.profiler.record_function`` ranges
that the benchmark opens around its calls into the program) come back as
a :class:`Trace`, on one clock, in microseconds.

The traced window runs from the first span's start to the last span's
end, or, where the callable first queues work of its own and then a
marker kernel, from the marker's end: the work after it then starts on a
card that is already busy, as in the measured window. The device is busy where the union of its events covers the window
and idle elsewhere; each idle gap is labelled by the innermost span open
at its middle, which says what the host was doing meanwhile.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]  # (name, start us, end us)
    spans: List[Tuple[str, float, float]]
    window: Interval

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Interval]:
        return union([(s, e) for _, s, e in self.kernels], self.window)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the events whose names hold one of
        ``patterns``, summed (not their union)."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.kernels
                   if any(p in n for p in patterns) and e > lo and s < hi) * 1e-6

    def device_ops(self, top: int = 10) -> List[list]:
        """The ``top`` device operations by total seconds in the window."""
        by_name = defaultdict(float)
        lo, hi = self.window
        for n, s, e in self.kernels:
            if e > lo and s < hi:
                by_name[n] += (min(e, hi) - max(s, lo)) * 1e-6
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the window by what the host was doing, the
        ``top`` labels with the most."""
        by_label = defaultdict(float)
        for s, e in gaps(self.busy_intervals(), self.window):
            by_label[self.label((s + e) / 2)] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]

    def label(self, at: float) -> str:
        """The innermost span open at ``at``: the latest to start, of those
        the first to end."""
        open_spans = [(s, -e, n) for n, s, e in self.spans if s <= at <= e]
        return max(open_spans)[2] if open_spans else "outside spans"


def union(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    """The union of ``intervals`` clipped to ``window``, sorted."""
    lo, hi = window
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` that the sorted, disjoint ``busy`` leaves."""
    out, at = [], window[0]
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def profiled(fn: Callable[[], None], span_names: Sequence[str],
             start_after: Optional[str] = None) -> Trace:
    """``fn`` run twice under the profiler, the second run kept; ``fn``
    opens the spans it names with ``record_function`` and ends on a
    synchronisation inside its last span. With ``start_after`` the window
    starts at the end of the last device event whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            prof.step()
    kernels, spans = [], []
    names = set(span_names)
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            # a device-side user annotation spans kernels counted on their own
            if not getattr(evt, "is_user_annotation", False):
                kernels.append((evt.name, start, end))
        elif evt.name in names:
            spans.append((evt.name, start, end))
    return Trace(kernels, spans, traced_window(kernels, spans, start_after))


def traced_window(kernels, spans, start_after: Optional[str] = None) -> Interval:
    """From the first span's start, or the end of the last device event
    whose name holds ``start_after``, to the last span's end."""
    if not spans:
        raise RuntimeError("the profiler recorded none of the benchmark's spans")
    window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    if start_after is None:
        return window
    marks = [e for n, _, e in kernels if start_after in n]
    if not marks:
        raise RuntimeError(f"the profiler recorded no {start_after!r} marker on the card")
    return (max(marks), window[1])
