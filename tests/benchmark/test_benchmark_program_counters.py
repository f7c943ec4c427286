"""The readers of the program's counters: each metric's ratio over the
frames that record both of its counters, from a record of known frames
that mixes stats frames (the stats words) with plain ones; nothing from an
untraced run, from a record without counters, or from a program that
records none."""

from pathlib import Path
from types import SimpleNamespace

import benchmark_cpu
import pytest

from benchmark import harness
from csgrenderer_tpu_torch.utils import profiling

METRICS = Path(benchmark_cpu.REPO) / "benchmark" / "metrics"
# each frame's counters: segments and the plain counts on every frame, the
# stats words on frames 1 and 3 alone (one launch in two here)
FRAMES = {
    1: dict(segments=6400, leaf_scores=7040, masked_visits=320_000, segment_warp_steps=400,
            walk_warp_steps=1000, walk_lane_steps=24_000, shadow_lane_steps=6000),
    2: dict(segments=6000, leaf_scores=6900, masked_visits=310_000),
    3: dict(segments=5600, leaf_scores=5800, masked_visits=280_000, segment_warp_steps=350,
            walk_warp_steps=900, walk_lane_steps=20_000, shadow_lane_steps=3000),
    4: dict(segments=6200, leaf_scores=7000, masked_visits=300_000),
}
STATS = (1, 3)


def _sum(key, frames=tuple(FRAMES)):
    return sum(FRAMES[f][key] for f in frames)


EXPECTED = {
    "segment_lane_share.offline": 100 * _sum("segments", STATS)
    / (32 * _sum("segment_warp_steps", STATS)),
    "walk_steps_per_segment.offline": _sum("walk_lane_steps", STATS) / _sum("segments", STATS),
    "walk_lane_share.offline": 100 * _sum("walk_lane_steps", STATS)
    / (32 * _sum("walk_warp_steps", STATS)),
    "shadow_walk_share.nee": 100 * _sum("shadow_lane_steps", STATS)
    / _sum("walk_lane_steps", STATS),
    "leaf_scores_per_segment.solids": _sum("leaf_scores") / _sum("segments"),
    "masked_visits_per_segment.mesh": _sum("masked_visits") / _sum("segments"),
}


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", "t_" + name.replace(".", "_")).read


@pytest.fixture
def record():
    profiling.clear()

    def make(frames=FRAMES, counters=True):
        with profiling.recording():
            for number in sorted(frames):
                with profiling.frame("render.frame"):
                    with profiling.span("render.fence"):
                        for key, value in frames[number].items() if counters else ():
                            profiling.count("kernel." + key, value)
    yield make
    profiling.clear()


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_gives_its_ratio_over_the_frames_that_hold_it(metric, record):
    record()
    got = reader(metric)(SimpleNamespace(trace=True))
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_no_reading_untraced_without_counters_or_from_a_program_without_them(metric, record,
                                                                             monkeypatch):
    read = reader(metric)
    assert read(SimpleNamespace(trace=True)) is None  # an empty record
    record(counters=False)  # frames and spans, no counter
    assert profiling.spans() and read(SimpleNamespace(trace=True)) is None
    record()
    assert read(SimpleNamespace(trace=False)) is None
    plain = {f: {k: v for k, v in c.items() if k in ("segments",)} for f, c in FRAMES.items()}
    profiling.clear()
    record(plain)  # segments alone: no frame holds the other counter
    assert read(SimpleNamespace(trace=True)) is None
    monkeypatch.delattr(profiling, "counters")  # a program that records no counters
    assert read(SimpleNamespace(trace=True)) is None


def test_a_reader_reads_each_frame_by_its_number():
    """Two samples of one counter in a frame add up, and a frame that holds
    one counter of a pair alone does not count toward the other."""
    profiling.clear()
    with profiling.recording():
        with profiling.frame("render.frame"):
            profiling.count("kernel.segments", 100)
            profiling.count("kernel.segments", 60)
            profiling.count("kernel.walk_lane_steps", 800)
        with profiling.frame("render.frame"):
            profiling.count("kernel.walk_lane_steps", 500)  # no segments in this frame
    try:
        got = reader("walk_steps_per_segment.offline")(SimpleNamespace(trace=True))
    finally:
        profiling.clear()
    assert got == pytest.approx(800 / 160)
