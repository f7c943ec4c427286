"""The readers of the program's spans: ms a frame from a record of known
spans, nothing from an untraced run or an empty record, and on a tiny
CPU window the spans' share of what the benchmark's own clock saw."""

from pathlib import Path
from types import SimpleNamespace

import benchmark_cpu
import pytest
import torch

from benchmark import devicetrace, harness
from csgrenderer_tpu_torch.utils import profiling

METRICS = Path(benchmark_cpu.REPO) / "benchmark" / "metrics"
MS = 1_000_000  # ns
FRAMES = 4
# each cell's frame, as (span, ms) with the spans inside the frame nested one level
LIVE = [("render.launch", 0.125), ("render.denoise", 0.375), ("render.tonemap", 0.0625)]
LIVE_GLUE, LIVE_READBACK = 0.03125, 0.25
OFFLINE = [("render.launch", 0.25), ("render.fence", 21.5), ("render.accumulate", 0.125),
           ("render.tonemap", 0.0625)]
OFFLINE_GLUE = 0.0625
EXPECTED = {
    "host_launch_ms.realtime": ("live", 0.125),
    "host_denoise_ms.realtime": ("live", 0.375),
    "host_tonemap_ms.realtime": ("live", 0.0625),
    "host_wait_ms.realtime": ("live", 0.25),
    "host_wait_ms.offline": ("offline", 21.5),
    "host_busy_ms.offline": ("offline", 0.25 + 0.125 + 0.0625 + 0.0625),
}


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", "t_" + name.replace(".", "_")).read


class Clock:
    def __init__(self):
        self.now = 1_790_000_000 * 10**9

    def __call__(self):
        return self.now

    def advance(self, ms):
        self.now += int(ms * MS)


def record(kind, clock):
    """``FRAMES`` frames of the cell ``kind`` on the fake clock."""
    inside, glue = (LIVE, LIVE_GLUE) if kind == "live" else (OFFLINE, OFFLINE_GLUE)
    with profiling.recording():
        for _ in range(FRAMES):
            with profiling.frame("render.frame"):
                for name, ms in inside:
                    with profiling.span(name):
                        clock.advance(ms)
                clock.advance(glue)
            if kind == "live":
                with profiling.span("app.readback"):
                    clock.advance(LIVE_READBACK)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(profiling.RECORDER, "clock", c)
    profiling.clear()
    yield c
    profiling.clear()


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_gives_its_spans_ms_a_frame(metric, clock):
    kind, want = EXPECTED[metric]
    record(kind, clock)
    assert reader(metric)(SimpleNamespace(trace=True)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_no_reading_untraced_or_from_an_empty_record(metric, clock):
    assert reader(metric)(SimpleNamespace(trace=True)) is None
    record(EXPECTED[metric][0], clock)
    assert reader(metric)(SimpleNamespace(trace=False)) is None


def _window_under_recording(cell):
    """A tiny CPU run of ``cell`` whose window alone is recorded; read as a
    traced run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = harness.find(cell, spec=benchmark_cpu.spec(), mix_overrides=benchmark_cpu.TINY[cell],
                           seed=benchmark_cpu.SEED, seconds=0.3, trace=False,
                           device=torch.device("cpu"), t_start=0.0)
        run.driver.setup(run)
        profiling.clear()
        with profiling.recording():
            run.driver.window(run, devicetrace.Tracer(False))
        run.driver.release(run)
    finally:
        torch.set_num_threads(threads)
    run.trace = True
    return run


def test_the_offline_frame_is_its_wait_and_its_busy_time():
    run = _window_under_recording("rtiow-offline-1080p64")
    wait, busy = reader("host_wait_ms.offline")(run), reader("host_busy_ms.offline")(run)
    assert wait > 0 and busy > 0
    interval_ms = 1e3 * run.window_s / len(run.frames)
    assert 0.8 * interval_ms <= wait + busy <= interval_ms
    profiling.clear()


def test_the_live_enqueue_is_launch_denoise_and_tonemap():
    run = _window_under_recording("rtiow-realtime-denoised-720p2")
    parts = sum(reader(m)(run) for m in ("host_launch_ms.realtime", "host_denoise_ms.realtime",
                                         "host_tonemap_ms.realtime"))
    enqueue = reader("host_enqueue_ms.realtime")(run)
    assert 0.8 * enqueue <= parts <= enqueue
    assert reader("host_wait_ms.realtime")(run) >= 0
    profiling.clear()
