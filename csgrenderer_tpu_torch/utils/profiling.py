"""Tracing: the program's own spans and device traces.

The JAX package's ``utils/profiling.py`` holds its ``trace`` and a call
timer; the port keeps ``trace`` and records spans in place of the timer.

- ``span(name)`` and ``frame(name)``: context managers that record one
  span each (``Span``: name, start and end in ``time.time_ns()``, which is
  the clock ``torch.profiler`` stamps its events with, the index of the
  enclosing span, and the frame number). ``frame`` marks the outermost
  span of a frame, which takes the next frame number; every span opened
  until the next frame begins shares it.
- Recording is on while ``torch.profiler`` records or inside
  ``recording()``. Whether it is on is read when a frame begins (a
  ``frame`` span, or ``poll()``, which ``App.run`` calls every iteration)
  and when a span opens outside any recorded span; spans inside a frame
  read that answer. Off, ``span`` and ``frame`` return one shared no-op
  and allocate nothing.
- ``count(name, value)``: one sample of a counter (``Count``: name,
  value, the frame number it lies in, and the time in ``time.time_ns()``),
  kept while recording is on; off, it returns at once and allocates
  nothing. The renderer records its kernels' work counts so, at each
  frame's fence.
- ``sample(every)``: while recording is on, true for the first call since
  the last ``clear()`` and every ``every``-th after it; false while off.
  The kernel wrappers ask it whether a launch counts its stats.
- The spans and the counter samples are kept in memory, at most
  ``CAPACITY`` of each; past that, ``dropped()`` counts what was left
  out. ``spans()`` and ``counters()`` return them and ``clear()`` empties
  the record.
- ``trace(dir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto) of the CPU and,
  where there is one, the CUDA timeline, with the spans recorded inside
  the block on a thread of their own and the counter samples as counter
  tracks of the same process, on the same clock.

The spans are not ``torch.profiler.record_function`` ranges: the profiler
mirrors each such range onto the device's timeline, where it would read
as device work. Spans are recorded from the thread that renders.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

CAPACITY = 1 << 20  # spans held at most, and counter samples
SPAN_THREAD = "program spans"  # the spans' thread in trace.json
SPAN_TID = 2**31 - 1  # its thread id: above any the kernel hands out
_profiler_enabled = torch.autograd._profiler_enabled  # looked up once: poll() runs every frame


class Span:
    """One recorded span. ``parent`` is the index in ``spans()`` of the
    span that encloses it (None outside any); ``frame`` the number of the
    frame it lies in (0 before the first); ``end_ns`` is None while it is
    open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "frame", "index", "begins")

    def __init__(self, name: str, begins: bool):
        self.name = name
        self.begins = begins  # a frame's outermost span

    def __enter__(self):
        rec = RECORDER
        if self.begins and not rec.open:
            rec.frames += 1
        self.frame = rec.frames
        self.parent = rec.open[-1].index if rec.open else None
        self.index = len(rec.records)
        self.end_ns = None
        rec.records.append(self)
        rec.open.append(self)
        self.start_ns = rec.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = RECORDER
        self.end_ns = rec.clock()
        if rec.open and rec.open[-1] is self:  # clear() may have emptied it
            rec.open.pop()
        return False


class _Off:
    """The shared no-op that ``span`` and ``frame`` return while off.

    Its ``__enter__`` and ``__exit__`` are one C function: ``str.format``
    of the empty string takes any arguments and returns "", which is false,
    so an exception raised inside passes on. Methods written in Python
    cost the ``with`` two interpreter frames, which took a live frame's
    disabled spans from about 1.1 to 1.7 us on the H100's host."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


OFF = _Off()


class Count:
    """One recorded sample of a counter: ``value`` of ``name`` in frame
    ``frame`` (0 before the first), taken at ``time_ns``."""

    __slots__ = ("name", "value", "frame", "time_ns")

    def __init__(self, name: str, value: int, frame: int, time_ns: int):
        self.name, self.value, self.frame, self.time_ns = name, value, frame, time_ns


class Recorder:
    """The process's record of spans (one: ``RECORDER``)."""

    def __init__(self):
        self.capacity = CAPACITY
        self.clock = time.time_ns
        self.on = False  # the answer of the last poll()
        self.forced = 0  # depth of recording() blocks
        self.records: list[Span] = []
        self.open: list[Span] = []  # the recorded spans still open, innermost last
        self.counts: list[Count] = []
        self.frames = 0
        self.dropped = 0
        self.samples = 0  # sample()'s calls while on since the last clear()

    def new(self, name: str, begins: bool):
        if len(self.records) >= self.capacity:
            self.dropped += 1
            return OFF
        return Span(name, begins)


RECORDER = Recorder()


def poll() -> bool:
    """Read whether recording is on (the profiler records, or a
    ``recording()`` block is open); spans until the next poll keep the
    answer."""
    rec = RECORDER
    rec.on = rec.forced > 0 or _profiler_enabled()
    return rec.on


def span(name: str):
    """A span of ``name``, recorded if recording is on."""
    rec = RECORDER
    if not rec.on or (not rec.open and not poll()):
        return OFF
    return rec.new(name, False)


def frame(name: str):
    """The outermost span of a frame: reads whether recording is on, and
    outside any recorded span begins the next frame number."""
    rec = RECORDER
    if not (rec.on if rec.open else poll()):
        return OFF
    return rec.new(name, True)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without the profiler."""
    rec = RECORDER
    rec.forced += 1
    poll()
    try:
        yield
    finally:
        rec.forced -= 1
        poll()


def count(name: str, value: int) -> None:
    """Record ``value`` of the counter ``name`` in the current frame, if
    recording is on (the answer spans read)."""
    rec = RECORDER
    if not rec.on:
        return
    if len(rec.counts) >= rec.capacity:
        rec.dropped += 1
        return
    rec.counts.append(Count(name, value, rec.frames, rec.clock()))


def sample(every: int) -> bool:
    """While recording is on, true for the first call since the last
    ``clear()`` and every ``every``-th call after it; false, and not
    counted, while off."""
    rec = RECORDER
    if not rec.on:
        return False
    n = rec.samples
    rec.samples = n + 1
    return n % every == 0


def spans() -> list[Span]:
    """The recorded spans, in the order they opened."""
    return list(RECORDER.records)


def counters() -> list[Count]:
    """The recorded counter samples, in the order they were taken."""
    return list(RECORDER.counts)


def dropped() -> int:
    """Spans and counter samples left out since the last ``clear()``: the
    record was full."""
    return RECORDER.dropped


def clear() -> None:
    rec = RECORDER
    rec.records, rec.open, rec.counts = [], [], []
    rec.frames = rec.dropped = rec.samples = 0


def _chrome_events(recorded, base_ns: int, pid: int, samples=()) -> list[dict]:
    """``recorded`` spans as Chrome trace events on thread ``SPAN_TID`` of
    ``pid``, and the counter ``samples`` as counter events of ``pid`` (a
    track a counter), in microseconds from ``base_ns``."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
            "args": {"name": SPAN_THREAD}}]
    for s in recorded:
        if s.end_ns is None:
            continue
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": SPAN_TID, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"frame": s.frame, "parent": s.parent}})
    for c in samples:
        out.append({"ph": "C", "cat": "program_counter", "name": c.name, "pid": pid,
                    "tid": SPAN_TID, "ts": (c.time_ns - base_ns) / 1e3,
                    "args": {"value": c.value}})
    return out


@contextlib.contextmanager
def trace(log_dir: str = "csgr-trace"):
    """Capture a trace of the block into ``log_dir/trace.json``, the
    program's spans and counter samples of the block beside the profiler's
    events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    try:
        with profile(activities=activities) as prof:
            poll()
            yield log_dir
    finally:
        poll()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # the profiler writes its times in microseconds from this base, or
    # from the epoch where it names none
    doc["traceEvents"] += _chrome_events(spans(), int(doc.get("baseTimeNanoseconds", 0)),
                                         os.getpid(), counters())
    with open(path, "w") as f:
        json.dump(doc, f)
