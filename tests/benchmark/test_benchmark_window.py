"""Window statistics: the end-to-end readers over synthetic windows, and
the reduction of a trace to busy time and idle gaps."""

from pathlib import Path
from types import SimpleNamespace

import benchmark_cpu
import pytest

from benchmark import devicetrace, harness

METRICS = Path(benchmark_cpu.REPO) / "benchmark" / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", "t_" + name.replace(".", "_")).read


def window(gaps, rays=1_000_000, stall_at=None, stall=0.0):
    """A Run-like window: frames delivered ``gaps`` apart, ``stall``
    seconds added before frame ``stall_at``."""
    t, frames = 0.0, []
    for i, g in enumerate(gaps):
        t += g + (stall if i == stall_at else 0.0)
        frames.append((t, rays))
    return SimpleNamespace(frames=frames, t0=0.0, t1=t, window_s=t, setup_s=1.5)


STEADY = [0.001] * 1000


@pytest.mark.parametrize("name", ["mrays_per_s", "frames_per_s"])
def test_a_stall_lowers_the_rate(name):
    read = reader(name)
    steady = read(window(STEADY))
    stalled = read(window(STEADY, stall_at=500, stall=0.2))
    assert stalled < steady * 0.9


def test_a_rate_counts_every_frame_over_the_whole_window():
    run = window(STEADY, rays=2_000_000)
    assert reader("mrays_per_s")(run) == pytest.approx(2.0 / 0.001)
    assert reader("frames_per_s")(run) == pytest.approx(1000.0)


def test_stalls_raise_the_p95():
    read = reader("frame_ms_p95")
    steady = read(window(STEADY))
    assert steady == pytest.approx(1.0)
    # 10% of the frames stall by 5 ms: the 95th percentile sees them
    gaps = [0.001 + (0.005 if i % 10 == 0 else 0.0) for i in range(1000)]
    assert read(window(gaps)) > 5.0


def test_no_rate_from_an_empty_window():
    empty = SimpleNamespace(frames=[], window_s=0.0)
    for name in ("mrays_per_s", "frames_per_s", "frame_ms_p95"):
        assert reader(name)(empty) is None


def ev(name, start, end, dev):
    return (name, int(start * 1e9), int(end * 1e9), dev)


def test_busy_time_is_the_union_of_device_intervals_in_the_window():
    events = [ev(devicetrace.WINDOW_SPAN, 1.0, 2.0, False),
              ev("draw_frame", 1.0, 1.5, False), ev("draw_frame", 1.5, 2.0, False),
              ev("kernel_a", 1.0, 1.4, True), ev("kernel_b", 1.3, 1.45, True),  # overlap
              ev("copy", 1.6, 1.9, True), ev("kernel_a", 0.5, 1.1, True),  # clipped
              ev("draw_frame", 1.0, 2.0, True)]  # the span's mirror on the device
    s = devicetrace.reduce_events(events, {"draw_frame"})
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(0.45 + 0.3)
    assert s.kernel_seconds("kernel_a") == pytest.approx(0.4 + 0.1)
    assert "draw_frame" not in s.device_s
    assert s.gaps_s["draw_frame"] == pytest.approx(0.1 + 0.05 + 0.1)
    idle = reader("device_idle_share.offline")(SimpleNamespace(summary=s))
    assert idle == pytest.approx(25.0)


def test_a_gap_is_put_down_to_the_innermost_span():
    events = [ev(devicetrace.WINDOW_SPAN, 0.0, 1.0, False), ev("app.run", 0.0, 1.0, False),
              ev("sink", 0.2, 0.4, False), ev("k", 0.0, 0.1, True), ev("k", 0.5, 1.0, True)]
    s = devicetrace.reduce_events(events, {"app.run", "sink"})
    # the gap [0.1, 0.5] holds the sink's [0.2, 0.4]
    assert s.gaps_s == {"app.run": pytest.approx(0.2), "sink": pytest.approx(0.2)}
    assert s.breakdown()["device_ops"] == [["k", pytest.approx(0.6)]]


def test_no_summary_without_the_window_span():
    assert devicetrace.reduce_events([ev("k", 0, 1, True)], set()) is None
