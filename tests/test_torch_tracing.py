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


# --- counter samples -----------------------------------------------------------


def test_a_count_while_off_returns_at_once_and_allocates_nothing():
    import tracemalloc

    assert profiling.poll() is False
    profiling.count("kernel.segments", 7)  # warm: any first-call allocation happens here
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(100):
            profiling.count("kernel.segments", 7)
            assert profiling.sample(8) is False
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename.endswith("profiling.py")]
    assert grown == []
    assert profiling.counters() == [] and profiling.RECORDER.samples == 0


def test_counter_samples_take_the_frame_numbers_of_spans(monkeypatch):
    clock = iter(range(1000, 10**6, 10))
    monkeypatch.setattr(profiling.RECORDER, "clock", lambda: next(clock))
    with profiling.recording():
        profiling.count("setup", 1)
        for k in range(3):
            with profiling.frame("render.frame"):
                with profiling.span("render.fence"):
                    profiling.count("kernel.segments", 10 + k)
                profiling.count("kernel.walk_lane_steps", 20 + k)
    spans, counts = profiling.spans(), profiling.counters()
    assert [(c.name, c.value, c.frame) for c in counts] == [
        ("setup", 1, 0), ("kernel.segments", 10, 1), ("kernel.walk_lane_steps", 20, 1),
        ("kernel.segments", 11, 2), ("kernel.walk_lane_steps", 21, 2),
        ("kernel.segments", 12, 3), ("kernel.walk_lane_steps", 22, 3)]
    fences = [s for s in spans if s.name == "render.fence"]
    for s, c in zip(fences, (c for c in counts if c.name == "kernel.segments")):
        assert s.frame == c.frame and s.start_ns < c.time_ns < s.end_ns


def test_sample_takes_the_first_call_and_every_nth_after_it_while_on():
    assert [profiling.sample(3) for _ in range(2)] == [False, False]  # off: not counted
    with profiling.recording():
        assert [profiling.sample(3) for _ in range(7)] == [True, False, False, True, False,
                                                           False, True]
        profiling.clear()
        assert profiling.sample(3) is True  # clear() starts the count again


def test_past_the_cap_counter_samples_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling.RECORDER, "capacity", 2)
    with profiling.recording():
        with profiling.frame("render.frame"):
            for v in range(3):
                profiling.count("kernel.segments", v)
    assert [c.value for c in profiling.counters()] == [0, 1]
    assert [s.name for s in profiling.spans()] == ["render.frame"]
    assert profiling.dropped() == 1
    with profiling.recording():
        profiling.sample(8)
    profiling.clear()
    assert profiling.counters() == [] and profiling.dropped() == 0
    assert profiling.RECORDER.samples == 0


def test_the_trace_file_holds_the_counter_samples(tmp_path):
    import json

    r = _renderer(progressive=True)
    r.draw_frame(0.0)
    with profiling.trace(str(tmp_path / "trace")):
        r.draw_frame(0.0)
        r.draw_frame(0.0)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    counters = [e for e in events if e.get("ph") == "C"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [(e["name"], e["args"]) for e in counters] == [
        (c.name, {"value": c.value}) for c in profiling.counters()]
    assert [e["args"]["value"] for e in counters if e["name"] == "kernel.segments"] == [
        c.value for c in profiling.counters() if c.name == "kernel.segments"]
    assert {e["pid"] for e in counters} == {spans[0]["pid"]}
    assert all(e["cat"] == "program_counter" for e in counters)
    fences = [e for e in spans if e["name"] == "render.fence"]
    segments = [e for e in counters if e["name"] == "kernel.segments"]
    assert len(segments) == len(fences) == 2
    for fence, sample in zip(fences, segments):  # on the spans' clock, inside the fence
        assert fence["ts"] <= sample["ts"] <= fence["ts"] + fence["dur"]


def _walk_frames():
    from csgrenderer_tpu_torch.kernels import megakernel, tape_kernel, trimesh_kernel
    from csgrenderer_tpu_torch.models import many_objects_scene, mesh_demo_scene, rtiow_final_scene

    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=2.0)
    top = Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0, aspect_ratio=2.0)
    mesh_cam = Camera.look_at((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), vfov_degrees=45.0,
                              aspect_ratio=2.0)
    return {  # scene, camera, its kernel wrapper, the plain walk's key in the wrapper's counts
        "sphere-grid": (rtiow_final_scene, cam, megakernel.render_image_kernel, "cell_visits"),
        "mesh-grid": (lambda: mesh_demo_scene(2), mesh_cam,
                      trimesh_kernel.render_image_mesh_kernel, "voxel_visits"),
        "tape-tree": (lambda: many_objects_scene(16).compile(k=4), top,
                      tape_kernel.render_image_tape_kernel, "node_visits"),
    }


@pytest.mark.parametrize("case", ["sphere-grid", "mesh-grid", "tape-tree"])
def test_a_recorded_plain_frame_records_its_segments_and_its_walk(case):
    """On the CPU every recorded frame records ``kernel.segments`` (the
    frame's segments) and the plain walk's lane turns as
    ``kernel.walk_lane_steps``: the count the kernel wrapper's plain version
    gives for the same frame (cell, voxel or node visits); no warp word
    (the CPU has no warps). Nothing is recorded while off."""
    make, cam, render, walk_key = _walk_frames()[case]
    frame = dict(width=16, height=8, spp=1, max_bounces=3, seed=5)
    r = PathTraceRenderer(make(), cam, RenderConfig(**frame), progressive=True, device="cpu")
    with profiling.recording():
        for _ in range(2):
            r.draw_frame(0.0)
    by_frame = {}
    for c in profiling.counters():
        by_frame.setdefault(c.frame, {})[c.name] = c.value
    assert sorted(by_frame) == [1, 2]
    for k, got in enumerate(by_frame[f] for f in (1, 2)):
        assert set(got) <= {"kernel.segments", "kernel.walk_lane_steps", "kernel.leaf_scores",
                            "kernel.masked_visits", "kernel.coarse_skips"}
        plain = {}
        _, rays = render(r._packed, cam, sample_offset=k * frame["spp"], counts=plain, **frame)
        assert got["kernel.segments"] == int(rays) > 0
        # a mesh walk's turns: its fine visits and its coarse skips
        walked = int(plain[walk_key]) + int(plain.get("coarse_skips", 0))
        assert got["kernel.walk_lane_steps"] == walked > 0
    assert r.last_frame_rays == by_frame[2]["kernel.segments"]
    profiling.clear()
    r.draw_frame(0.0)
    assert profiling.counters() == []


def test_a_queued_frame_records_its_own_stats_block(monkeypatch):
    """Frames queued behind each other (the card's "queue" schedule, run
    here on CPU tensors) each record the stats block of the launch whose
    segments they read, under their own frame number; the launches that
    take a block are the first and every ``STATS_EVERY``-th after it."""
    from csgrenderer_tpu_torch.app import renderers
    from csgrenderer_tpu_torch.kernels import build

    schedule = renderers.frame_schedule
    monkeypatch.setattr(renderers, "frame_schedule",
                        lambda device, *a: schedule(torch.device("cuda", 0), *a))
    monkeypatch.setattr(build, "STATS_EVERY", 2)
    launches = []
    render = renderers._render_kernel

    def with_stats(*args, counts=None, **kw):
        out = render(*args, counts=counts, **kw)
        n = len(launches) + 1
        launches.append(int(out[1]))
        if counts is not None and build.stats_launch():
            counts["stats"] = torch.tensor([n, 10 * n, 100 * n])
        return out

    monkeypatch.setattr(renderers, "_render_kernel", with_stats)
    r = _renderer(progressive=True)
    assert r._schedule == "queue"
    with profiling.recording():
        for _ in range(5):
            r.draw_frame(0.0)
    assert len(launches) == 6  # the fifth frame queued a sixth launch
    by_frame = {}
    for c in profiling.counters():
        by_frame.setdefault(c.frame, {})[c.name] = c.value
    for frame in range(1, 6):
        got = by_frame[frame]
        assert got["kernel.segments"] == launches[frame - 1]
        stats = frame % 2 == 1  # launches 1, 3, 5: the first and every second after it
        assert ("kernel.segment_warp_steps" in got) == stats
        if stats:
            assert (got["kernel.segment_warp_steps"], got["kernel.walk_warp_steps"],
                    got["kernel.walk_lane_steps"]) == (frame, 10 * frame, 100 * frame)
            assert "kernel.shadow_lane_steps" not in got
