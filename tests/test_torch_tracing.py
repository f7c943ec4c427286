"""The port's spans (``utils/profiling.py``) on the CPU: off by default,
one shared no-op; the frame's spans with their parents and frame numbers
under ``recording()``; ``App.run``'s readback; the profiler's clock; and
the record's cap."""

import pytest
import torch

from csgrenderer_tpu_torch.app import App, PathTraceRenderer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.models import animated_csg_scene, two_spheres_scene
from csgrenderer_tpu_torch.utils import profiling
from csgrenderer_tpu_torch.utils.config import RenderConfig

FRAME_SPANS = ("render.frame", "render.animate", "render.recluster", "scene.pack",
               "render.launch", "render.fence", "render.accumulate", "render.denoise",
               "render.tonemap", "app.readback")


@pytest.fixture(autouse=True)
def empty_record():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    profiling.poll()
    torch.set_num_threads(threads)


def _cam():
    return Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)


def _renderer(**kw):
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2, **kw.pop("config", {}))
    return PathTraceRenderer(two_spheres_scene(), _cam(), cfg, device="cpu", **kw)


def _children(recorded, parent):
    return [s.name for s in recorded if s.parent == parent]


def _nested(recorded):
    for s in recorded:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = recorded[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and s.frame == p.frame


def test_off_records_nothing_and_hands_out_the_shared_noop():
    assert profiling.poll() is False
    assert profiling.span("render.launch") is profiling.OFF
    assert profiling.frame("render.frame") is profiling.OFF
    _renderer(progressive=True).draw_frame(0.0)
    _renderer(advance_samples=True).draw_frame_async(0.0)
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("on", [False, True])
def test_an_exception_passes_through_a_span(on):
    with profiling.recording() if on else profiling.OFF:
        with pytest.raises(ValueError, match="inside"):
            with profiling.frame("render.frame"):
                with profiling.span("render.launch"):
                    raise ValueError("inside")
        with profiling.frame("render.frame"):
            pass
    assert [(s.name, s.parent, s.frame) for s in profiling.spans()] == (
        [("render.frame", None, 1), ("render.launch", 0, 1), ("render.frame", None, 2)]
        if on else [])


def test_a_progressive_frame_records_its_spans_inside_render_frame():
    r = _renderer(progressive=True)
    with profiling.recording():
        r.draw_frame(0.0)
        r.draw_frame(0.0)
    recorded = profiling.spans()
    frames = [i for i, s in enumerate(recorded) if s.name == "render.frame"]
    assert len(frames) == 2
    for number, i in enumerate(frames, start=1):
        assert recorded[i].parent is None and recorded[i].frame == number
        assert _children(recorded, i) == ["render.launch", "render.accumulate", "render.tonemap",
                                          "render.fence"]
    _nested(recorded)
    assert {s.frame for s in recorded} == {1, 2}
    assert profiling.span("render.launch") is profiling.OFF  # off again after the block


def test_a_denoised_frame_records_render_denoise():
    r = _renderer(advance_samples=True, config=dict(denoise=True, denoise_iterations=2))
    with profiling.recording():
        r.draw_frame_async(0.0)
    recorded = profiling.spans()
    assert recorded[0].name == "render.frame"
    assert _children(recorded, 0) == ["render.launch", "render.denoise", "render.tonemap"]
    _nested(recorded)


def test_an_animated_tape_frame_records_animate_recluster_and_pack():
    graph, animate = animated_csg_scene(3)
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2)
    r = PathTraceRenderer(graph.compile(), _cam(), cfg, animate=animate, device="cpu")
    with profiling.recording():
        r.draw_frame(0.5)
    recorded = profiling.spans()
    assert _children(recorded, 0) == ["render.animate", "render.recluster", "render.launch",
                                      "render.tonemap", "render.fence"]
    launch = next(i for i, s in enumerate(recorded) if s.name == "render.launch")
    assert _children(recorded, launch) == ["scene.pack"]
    _nested(recorded)


@pytest.mark.parametrize("readback", ["fence", "full"])
def test_a_pipelined_app_run_records_one_readback_a_frame(readback):
    app = App(width=16, height=8)
    app.swap_scene(_renderer(advance_samples=True))
    with profiling.recording():
        app.run(max_frames=4, frames_in_flight=2, readback=readback)
    recorded = profiling.spans()
    readbacks = [s for s in recorded if s.name == "app.readback"]
    assert len(readbacks) == 4 == sum(s.name == "render.frame" for s in recorded)
    assert all(s.parent is None for s in readbacks)
    # the oldest frame is read back after the next is dispatched
    assert [s.frame for s in readbacks] == [2, 3, 4, 4]
    _nested(recorded)


def test_spans_lie_on_the_profilers_clock_and_stay_off_its_events():
    from torch.profiler import ProfilerActivity, profile, record_function

    r = _renderer(progressive=True)
    r.draw_frame(0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("benchmark.draw_frame"):
                r.draw_frame(0.0)
    recorded = profiling.spans()
    assert [s.name for s in recorded if s.parent is None] == ["render.frame"] * 3
    events = list(prof.profiler.kineto_results.events())
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name() == "benchmark.draw_frame")
    assert len(ranges) == 3
    slack = 50_000
    for (start, end), s in zip(ranges, (s for s in recorded if s.name == "render.frame")):
        assert start - slack <= s.start_ns and s.end_ns <= end + slack
    assert not {e.name() for e in events} & set(FRAME_SPANS)
    # the profiler has stopped: the next span outside a frame reads so
    assert profiling.span("scene.pack") is profiling.OFF


def test_past_the_cap_spans_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "capacity", 3)
    with profiling.recording():
        for _ in range(2):
            with profiling.frame("render.frame"):
                with profiling.span("render.launch"):
                    pass
    assert [s.name for s in profiling.spans()] == ["render.frame", "render.launch",
                                                   "render.frame"]
    assert profiling.dropped() == 1
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0
