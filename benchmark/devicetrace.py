"""The traced window: torch.profiler over the measured loop, reduced.

``Tracer(enabled)`` gives the traffic drivers ``span(name)``, a
``record_function`` around each call into the program when tracing and
nothing otherwise, and ``window()``, which wraps the measured loop (the
device drained on both sides) in the profiler and one outer span.
``summary()`` reduces the profiler's events to what the per-layer metrics
read (``Summary``): device seconds by operation name, the union of the
device's busy intervals inside the window, and the idle gaps, each piece
of a gap put down to the innermost benchmark span that the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "benchmark.window"
TOP = 10  # entries of each breakdown list


@dataclass
class Summary:
    window_s: float  # the traced window, on the profiler's clock
    busy_s: float  # union of the device's kernel, copy and set intervals in it
    device_s: dict = field(default_factory=dict)  # device seconds by operation name
    gaps_s: dict = field(default_factory=dict)  # idle seconds by what the host was doing

    def kernel_seconds(self, key: str) -> float:
        """Device seconds of the operations whose name contains ``key``."""
        return sum(s for name, s in self.device_s.items() if key in name)

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with self.prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
                torch.cuda.synchronize()

    def summary(self, span_names) -> Summary | None:
        if self.prof is None:
            return None
        return reduce_events(_events(self.prof), set(span_names))


def _events(prof):
    """(name, start ns, end ns, on the device) of every profiler event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns(), e.device_type() == cuda))
    return out


def reduce_events(events, span_names: set) -> Summary | None:
    """``events``: (name, start ns, end ns, on the device). The window is
    the span ``WINDOW_SPAN``; device events are clipped to it, and the
    device-side copies of the benchmark's spans are left out."""
    window = [(s, e) for n, s, e, dev in events if not dev and n == WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0]
    # the profiler mirrors each span on the device's timeline: not device work
    annotations = span_names | {WINDOW_SPAN}
    device_s: dict = {}
    intervals = []
    for name, s, e, dev in events:
        if not dev or name in annotations:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        device_s[name] = device_s.get(name, 0.0) + (e - s) * 1e-9
        intervals.append((s, e))
    intervals.sort()
    busy, gaps, cursor = 0, [], w0
    for s, e in intervals:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    spans: dict = {}
    for name, s, e, dev in events:
        if not dev and name in span_names:
            spans.setdefault(name, []).append((s, e))
    for v in spans.values():
        v.sort()
    starts = {n: [s for s, _ in v] for n, v in spans.items()}
    gaps_s: dict = {}
    for g0, g1 in gaps:
        # cut the gap where a span begins or ends inside it; each piece goes
        # to the innermost span that holds it
        cuts = {g0, g1}
        for name, v in spans.items():
            for s, e in v[max(0, bisect.bisect_right(starts[name], g0) - 1):
                          bisect.bisect_left(starts[name], g1)]:
                cuts.update(x for x in (s, e) if g0 < x < g1)
        cuts = sorted(cuts)
        for a, b in zip(cuts, cuts[1:]):
            label, latest = "benchmark loop", None
            for name, v in spans.items():
                i = bisect.bisect_right(starts[name], a) - 1
                if i >= 0 and v[i][1] > a and (latest is None or v[i][0] > latest):
                    label, latest = name, v[i][0]
            gaps_s[label] = gaps_s.get(label, 0.0) + (b - a) * 1e-9
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_s=device_s,
                   gaps_s=gaps_s)
