"""The reader of the queued progressive frame: the share of frames that
hold a ``render.prelaunch`` span, from records of known spans; nothing
untraced or from an empty record, and 0 where no frame queued the next
(an eager program)."""

from pathlib import Path
from types import SimpleNamespace

import benchmark_cpu
import pytest

from benchmark import harness
from csgrenderer_tpu_torch.utils import profiling

METRIC = "prelaunch_frame_share.offline"
MS = 1_000_000  # ns
TRACED = SimpleNamespace(trace=True)


def read(run):
    path = Path(benchmark_cpu.REPO) / "benchmark" / "metrics" / f"{METRIC}.py"
    return harness.load_module(path, "t_" + METRIC.replace(".", "_")).read(run)


@pytest.fixture
def clock(monkeypatch):
    now = [1_790_000_000 * 10**9]
    monkeypatch.setattr(profiling.RECORDER, "clock", lambda: now[0])
    profiling.clear()
    yield now
    profiling.clear()


def record(frames, now):
    """Progressive frames as ``frames`` lists them: "queued" a frame that
    enqueued the next one's kernel before its fence, "eager" one that
    rendered and fenced alone; each followed by the loop's own work."""
    with profiling.recording():
        for kind in frames:
            with profiling.frame("render.frame"):
                if kind == "eager":
                    with profiling.span("render.launch"):
                        now[0] += MS
                for name in ("render.accumulate", "render.tonemap"):
                    with profiling.span(name):
                        now[0] += MS // 4
                if kind == "queued":
                    with profiling.span("render.prelaunch"):
                        with profiling.span("render.launch"):
                            now[0] += MS
                with profiling.span("render.fence"):
                    now[0] += 10 * MS
            with profiling.span("bench.loop"):
                now[0] += MS // 8


@pytest.mark.parametrize("frames, share", [
    (["eager"] + ["queued"] * 3, 75.0),
    (["queued"] * 5, 100.0),
    (["eager", "eager", "queued", "eager"], 25.0),
])
def test_the_share_of_frames_that_queued_the_next(clock, frames, share):
    record(frames, clock)
    assert read(TRACED) == pytest.approx(share)


def test_a_prelaunch_nested_deeper_in_its_frame_counts_once(clock):
    with profiling.recording():
        with profiling.frame("render.frame"):
            with profiling.span("render.outer"):
                for _ in range(2):
                    with profiling.span("render.prelaunch"):
                        clock[0] += MS
        with profiling.frame("render.frame"):
            clock[0] += MS
    assert read(TRACED) == pytest.approx(50.0)


def test_zero_for_an_eager_program(clock):
    record(["eager"] * 4, clock)
    assert read(TRACED) == 0.0


def test_no_reading_untraced_or_from_an_empty_record(clock):
    assert read(TRACED) is None
    record(["queued"] * 2, clock)
    assert read(SimpleNamespace(trace=False)) is None


def test_no_reading_without_frames(clock):
    with profiling.recording():
        with profiling.span("render.prelaunch"):
            clock[0] += MS
    assert read(TRACED) is None
