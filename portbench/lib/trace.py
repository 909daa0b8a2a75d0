"""The traced window: a fixed number of the cell's iterations under ``torch.profiler``, and
the reduction of its events to what the per-layer readers and the breakdown read.

The device is busy where any device operation (kernel, copy, fill) runs: the union of
their intervals, so that operations on two streams that overlap count once. The window is
the host's span around the iterations, closed by a device synchronisation. An idle gap is
named by what the host was doing at its middle: the innermost of the benchmark's own spans
(``window``, ``estimator.fit``, ``trainer.step``, ``model.forward``, ...) and the outermost
operation the host was in on any thread, or ``python`` where it was in none.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Tuple

WINDOW = "window"
_NOT_LAUNCHES = ("Memcpy", "Memset")


@dataclass
class Trace:
    """What one traced window holds."""

    iterations: int
    window_s: float
    busy_s: float
    # device operations: (name, start µs, end µs)
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    # idle gaps by what the host was doing: label -> (seconds, count)
    gaps: Dict[str, Tuple[float, int]] = field(default_factory=dict)

    @property
    def launches(self) -> int:
        """Kernels launched on the device (copies and fills left out)."""
        return sum(1 for name, _, _ in self.device if not name.startswith(_NOT_LAUNCHES))

    def seconds_of(self, substrings: Iterable[str]) -> float:
        """Device seconds of the operations whose name holds one of ``substrings``."""
        subs = tuple(substrings)
        return sum(end - start for name, start, end in self.device if any(s in name for s in subs)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle time by what the
        host was doing, ``top`` of each, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, start, end in self.device:
            by_name[name[:160]] += (end - start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"{label} (x{count})", s] for label, (s, count) in gaps]}


def record(loop: Callable[[], int], spans: Iterable[str], sync: Callable[[], None]) -> Trace:
    """Run ``loop()`` (which returns the iterations it ran) under the profiler, inside the
    span ``window`` and closed by ``sync()``, the device's synchronisation, and reduce its
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            iterations = loop()
            sync()
    return reduce(prof.events(), iterations, set(spans) | {WINDOW})


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def reduce(events, iterations: int, span_names: set) -> Trace:
    """The :class:`Trace` of a profiler's ``events()`` (``torch.autograd.profiler``'s
    ``FunctionEvent``: ``name``, ``device_type``, ``time_range``, ``thread``, ``cpu_parent``)."""
    from torch.autograd import DeviceType

    windows = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device = []
    for e in events:
        # the device-side copies of the benchmark's spans (the profiler's user annotations) are
        # no operations
        if e.device_type == DeviceType.CUDA and e.name not in span_names:
            start, end = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if end > start:
                device.append((e.name, start, end))
    busy = _union([(s, e) for _, s, e in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    spans = [e for e in events if e.device_type == DeviceType.CPU and e.name in span_names]
    by_thread: Dict[int, List] = defaultdict(list)
    for e in events:
        if e.device_type != DeviceType.CPU or e.name in span_names:
            continue
        parent = e.cpu_parent
        if parent is None or parent.name in span_names:
            by_thread[e.thread].append(e)
    starts = {}
    for thread, evs in by_thread.items():
        evs.sort(key=lambda e: e.time_range.start)
        starts[thread] = [e.time_range.start for e in evs]

    def label(t: float) -> str:
        inside = [s for s in spans if s.time_range.start <= t < s.time_range.end]
        span = min(inside, key=lambda s: s.time_range.end - s.time_range.start).name if inside else "no span"
        op = "python"
        for thread, evs in by_thread.items():
            i = bisect.bisect_right(starts[thread], t) - 1
            if i >= 0 and evs[i].time_range.end > t:
                op = evs[i].name[:80]
                break
        return f"{span} > {op}"

    gaps: Dict[str, Tuple[float, int]] = {}
    for start, end in holes:
        key = label(0.5 * (start + end))
        s, n = gaps.get(key, (0.0, 0))
        gaps[key] = (s + (end - start) / 1e6, n + 1)
    return Trace(
        iterations=iterations,
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        device=device,
        gaps=gaps,
    )
