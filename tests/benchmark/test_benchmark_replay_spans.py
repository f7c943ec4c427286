"""The readers of the replayed live frame: ms a frame in ``render.replay``
and the share of frames that hold one, from records of known spans;
nothing untraced or from an empty record, and 0 where no frame replayed
(an eager program)."""

from pathlib import Path
from types import SimpleNamespace

import benchmark_cpu
import pytest

from benchmark import harness
from csgrenderer_tpu_torch.utils import profiling

METRICS = Path(benchmark_cpu.REPO) / "benchmark" / "metrics"
MS = 1_000_000  # ns
REPLAY_MS, EAGER_MS, READBACK_MS = 0.0625, 0.5, 0.125
READERS = ("host_replay_ms.realtime", "graph_frame_share.realtime")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", "t_" + name.replace(".", "_")).read


@pytest.fixture
def clock(monkeypatch):
    now = [1_790_000_000 * 10**9]
    monkeypatch.setattr(profiling.RECORDER, "clock", lambda: now[0])
    profiling.clear()
    yield now
    profiling.clear()


def record(frames, now):
    """Frames as ``frames`` lists them: "replay" a replayed frame, "eager"
    one enqueued launch by launch; each followed by the loop's readback."""
    with profiling.recording():
        for kind in frames:
            with profiling.frame("render.frame"):
                if kind == "replay":
                    with profiling.span("render.replay"):
                        now[0] += int(REPLAY_MS * MS)
                else:
                    for name in ("render.launch", "render.denoise", "render.tonemap"):
                        with profiling.span(name):
                            now[0] += int(EAGER_MS / 3 * MS)
            with profiling.span("app.readback"):
                now[0] += int(READBACK_MS * MS)


TRACED = SimpleNamespace(trace=True)


@pytest.mark.parametrize("frames, replay_ms, share", [
    (["eager"] + ["replay"] * 3, 3 * REPLAY_MS / 4, 75.0),
    (["replay"] * 5, REPLAY_MS, 100.0),
    (["eager", "eager", "replay", "eager"], REPLAY_MS / 4, 25.0),
])
def test_the_readers_count_the_replayed_frames(clock, frames, replay_ms, share):
    record(frames, clock)
    assert reader("host_replay_ms.realtime")(TRACED) == pytest.approx(replay_ms)
    assert reader("graph_frame_share.realtime")(TRACED) == pytest.approx(share)


def test_a_replay_nested_deeper_in_its_frame_counts_once(clock):
    with profiling.recording():
        with profiling.frame("render.frame"):
            with profiling.span("render.outer"):
                for _ in range(2):
                    with profiling.span("render.replay"):
                        clock[0] += MS
        with profiling.frame("render.frame"):
            clock[0] += MS
    assert reader("graph_frame_share.realtime")(TRACED) == pytest.approx(50.0)
    assert reader("host_replay_ms.realtime")(TRACED) == pytest.approx(1.0)


@pytest.mark.parametrize("metric", READERS)
def test_zero_where_no_frame_replayed(clock, metric):
    record(["eager"] * 4, clock)
    assert reader(metric)(TRACED) == 0.0


@pytest.mark.parametrize("metric", READERS)
def test_no_reading_untraced_or_from_an_empty_record(clock, metric):
    assert reader(metric)(TRACED) is None
    record(["replay"] * 2, clock)
    assert reader(metric)(SimpleNamespace(trace=False)) is None


@pytest.mark.parametrize("metric", READERS)
def test_no_reading_without_frames(clock, metric):
    with profiling.recording():
        with profiling.span("render.replay"):
            clock[0] += MS
    assert reader(metric)(TRACED) is None
