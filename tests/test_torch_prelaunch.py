"""How ``PathTraceRenderer``'s frames run, on the CPU: the one decision
(``renderers.frame_schedule``) that picks replay, queue or eager frames,
the CPU's progressive frames and spans, that ``Accumulator.add`` takes an
int count as it takes a tensor, and the queue's logic itself: which frame
each call renders, adopts or drops, and that its frames, accumulators and
counts equal the eager renderer's. The fence's pinned copy and event need
the card (tests/test_torch_cuda.py); here the queue runs on CPU tensors,
decided as if on the card, through the fence's CPU form."""

import dataclasses

import pytest
import torch

from csgrenderer_tpu_torch.app import PathTraceRenderer, renderers
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.io.checkpoint import Accumulator
from csgrenderer_tpu_torch.models import night_scene, two_spheres_scene
from csgrenderer_tpu_torch.render.tonemap import to_uint8, tonemap
from csgrenderer_tpu_torch.render.trimesh import icosphere
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph
from csgrenderer_tpu_torch.utils import profiling
from csgrenderer_tpu_torch.utils.config import RenderConfig

CFG = RenderConfig(width=8, height=4, spp=2, max_bounces=2, seed=3)
CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cam(x=0.0):
    return Camera.look_at((x, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)


def _tape():
    g = SceneGraph(max_node_count=4)
    a = g.add_sphere_node(0.5, Material.lambertian((0.7, 0.3, 0.3)))
    b = g.add_sphere_node(0.5, Material.metal((0.8, 0.8, 0.8), 0.2))
    g.add_union_of_node(NA(a, offset=(-1, 0, -3)), NA(b, offset=(1, 0, -3)))
    return g.compile(k=2)


def _night():
    return night_scene(grid=2)


def _mesh():
    return icosphere((0, 0, -3), 1.0, Material.lambertian((0.6, 0.3, 0.3)), 0)


SCENES = {
    "spheres": (two_spheres_scene, CFG),
    "tape": (_tape, CFG),
    "night-nee": (_night, dataclasses.replace(CFG, nee=True, sky="black")),
}


def _renderer(scene=None, cfg=CFG, **kw):
    return PathTraceRenderer(two_spheres_scene() if scene is None else scene, _cam(), cfg,
                             device="cpu", **kw)


def _as_on_card(monkeypatch):
    """Renderers made from here on decide how their frames run as if they
    lay on the card."""
    schedule = renderers.frame_schedule
    monkeypatch.setattr(renderers, "frame_schedule", lambda device, *a: schedule(CARD, *a))


@pytest.fixture
def queued(monkeypatch):
    """Every static progressive renderer queues its next frame; returns the
    sample offsets each ``_render`` call took."""
    offsets = []
    render = PathTraceRenderer._render

    def counted(self, time_sec, partition=None, counts=None):
        offsets.append(self._sample_offset)
        return render(self, time_sec, partition, counts)

    _as_on_card(monkeypatch)
    monkeypatch.setattr(PathTraceRenderer, "_render", counted)
    return offsets


def _eager(make, cfg, monkeypatch, steps):
    """Fresh renderers' frames for ``steps`` with nothing queued: each
    step a ``draw_frame`` (None) or a call on the renderer."""
    with monkeypatch.context() as m:
        m.setattr(renderers, "frame_schedule", lambda *a: "eager")
        return _drawn(_renderer(make(), cfg, progressive=True), steps)


def _drawn(r, steps):
    out = []
    for step in steps:
        if step is not None:
            step(r)
            continue
        image = r.draw_frame(0.0)
        out.append((image, r.accumulator.radiance_sum.clone(), int(r.accumulator.sample_count),
                    r.accumulator.rays_traced, r.last_frame_rays, r.last_frame_shadow_rays))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), k
        assert a[2:] == b[2:], k


def _still(scene, time_sec):
    return scene


PROGRESSIVE, ADVANCING = dict(progressive=True), dict(advance_samples=True)
SCHEDULES = {  # scene, on the card, the renderer's arguments, debug: how its frames run
    "spheres-card-one-shot": (two_spheres_scene, True, {}, False, "replay"),
    "spheres-card-advancing": (two_spheres_scene, True, ADVANCING, False, "replay"),
    "spheres-card-progressive": (two_spheres_scene, True, PROGRESSIVE, False, "queue"),
    "tape-card-progressive": (_tape, True, PROGRESSIVE, False, "queue"),
    "mesh-card-progressive": (_mesh, True, PROGRESSIVE, False, "queue"),
    "tape-card-advancing": (_tape, True, ADVANCING, False, "eager"),
    "mesh-card-one-shot": (_mesh, True, {}, False, "eager"),
    "spheres-card-animated-advancing": (two_spheres_scene, True,
                                        dict(ADVANCING, animate=_still), False, "eager"),
    "spheres-card-animated-progressive": (two_spheres_scene, True,
                                          dict(PROGRESSIVE, animate=_still), False, "eager"),
    "tape-card-animated-progressive": (_tape, True, dict(PROGRESSIVE, animate=_still), False,
                                       "eager"),
    "spheres-card-debug-advancing": (two_spheres_scene, True, ADVANCING, True, "eager"),
    "spheres-card-debug-progressive": (two_spheres_scene, True, PROGRESSIVE, True, "eager"),
    "spheres-cpu-advancing": (two_spheres_scene, False, ADVANCING, False, "eager"),
    "spheres-cpu-progressive": (two_spheres_scene, False, PROGRESSIVE, False, "eager"),
    "tape-cpu-progressive": (_tape, False, PROGRESSIVE, False, "eager"),
    "mesh-cpu-one-shot": (_mesh, False, {}, False, "eager"),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_one_decision_sets_how_frames_run(monkeypatch, case):
    """Only a static scene on the card without debug checks replays (a
    sphere scene's non-progressive frames) or queues (any scene's
    progressive frames); the renderer takes the decision once, when made,
    from its device, scene, animation, mode and config."""
    make, card, kw, debug, schedule = SCHEDULES[case]
    if card:
        _as_on_card(monkeypatch)
    r = _renderer(make(), dataclasses.replace(CFG, debug=debug), **kw)
    assert r._schedule == schedule


def test_cpu_progressive_frames_and_spans_are_unchanged():
    """On the CPU each progressive frame renders its own kernel at offset
    k spp, fenced after its tonemap, and records no prelaunch; its images
    are the accumulation of those frames, tonemapped."""
    r = _renderer(progressive=True)
    profiling.clear()
    try:
        with profiling.recording():
            images = [r.draw_frame(0.0) for _ in range(3)]
        names = [s.name for s in profiling.spans()]
    finally:
        profiling.clear()
    assert names == ["render.frame", "render.launch", "render.accumulate", "render.tonemap",
                     "render.fence"] * 3
    assert r._schedule == "eager" and r._ahead is None
    acc, rays = Accumulator.zeros(CFG.height, CFG.width), []
    for k, image in enumerate(images):
        radiance, n = renderers._render_kernel(r._packed, r.camera, CFG, k * CFG.spp)
        acc = acc.add(radiance * CFG.spp, CFG.spp, n)
        rays.append(int(n))
        assert torch.equal(image, to_uint8(tonemap(acc.image(), gamma=CFG.gamma))), k
    assert torch.equal(r.accumulator.radiance_sum, acc.radiance_sum)
    assert r.accumulator.rays_traced == sum(rays) and r.last_frame_rays == rays[-1]


def test_accumulator_add_takes_an_int_count_as_it_takes_the_tensor():
    radiance = torch.rand(4, 8, 3, generator=torch.Generator().manual_seed(1))
    rays = torch.tensor(12345, dtype=torch.int64)
    start = Accumulator.zeros(4, 8).add(radiance, 2, 7)
    by_tensor, by_int = start.add(radiance * 2, 2, rays), start.add(radiance * 2, 2, 12345)
    assert torch.equal(by_tensor.radiance_sum, by_int.radiance_sum)
    assert int(by_tensor.sample_count) == int(by_int.sample_count) == 4
    assert by_tensor.rays_traced == by_int.rays_traced == 12352
    assert type(by_int.rays_traced) is int


@pytest.mark.parametrize("name", sorted(SCENES))
def test_queued_frames_equal_the_eager_frames(queued, monkeypatch, name):
    """Five frames back to back: the first renders alone, the second
    renders and queues the third, each later call adopts its frame and
    queues the next; images, accumulators and counts equal the eager
    renderer's bit for bit."""
    make, cfg = SCENES[name]
    r = _renderer(make(), cfg, progressive=True)
    got = _drawn(r, [None] * 5)
    spp = cfg.spp
    assert queued == [0, spp, 2 * spp, 3 * spp, 4 * spp, 5 * spp]
    assert r._ahead is not None and r._sample_offset == 5 * spp
    _assert_same(got, _eager(make, cfg, monkeypatch, [None] * 5))
    if cfg.nee:
        assert all(frame[5] > 0 for frame in got)


def test_one_draw_renders_one_frame(queued):
    r = _renderer(progressive=True)
    r.draw_frame(0.0)
    assert queued == [0] and r._ahead is None
    r.draw_frame(0.0)
    assert queued == [0, CFG.spp, 2 * CFG.spp] and r._ahead is not None


def test_the_queued_frame_records_a_prelaunch_span(queued):
    r = _renderer(progressive=True)
    profiling.clear()
    try:
        with profiling.recording():
            for _ in range(3):
                r.draw_frame(0.0)
        recorded = profiling.spans()
    finally:
        profiling.clear()
    frames = [[s.name for s in recorded if s.frame == k] for k in (1, 2, 3)]
    assert frames[0] == ["render.frame", "render.launch", "render.accumulate", "render.tonemap",
                         "render.fence"]
    assert frames[1] == ["render.frame", "render.launch", "render.accumulate", "render.tonemap",
                         "render.prelaunch", "render.launch", "render.fence"]
    assert frames[2] == ["render.frame", "render.accumulate", "render.tonemap",
                         "render.prelaunch", "render.launch", "render.fence"]
    pre = next(s for s in recorded if s.frame == 3 and s.name == "render.prelaunch")
    launch = next(s for s in recorded if s.frame == 3 and s.name == "render.launch")
    assert launch.parent == pre.index and recorded[pre.parent].name == "render.frame"


STEPS = {  # a change of state, and the offsets (in spp) of every frame rendered around it
    "reset_accumulation": (lambda r: r.reset_accumulation(), [0, 1, 2, 3, 0, 1, 2, 3]),
    "set_camera": (lambda r: r.set_camera(_cam(0.25)), [0, 1, 2, 3, 3, 4, 5, 6]),
    "camera assigned": (lambda r: setattr(r, "camera", _cam(0.25)), [0, 1, 2, 3, 3, 4, 5, 6]),
    "render_to_noise": (lambda r: r.render_to_noise(target=1e-9, max_spp=2 * CFG.spp),
                        [0, 1, 2, 3, 3, 4, 5, 6, 7, 8]),
}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_a_state_change_between_frames_drops_the_queued_frame(queued, monkeypatch, step):
    """Three frames, a change of the renderer's state, three more: the
    frame queued before the change (offset 3 spp) is never adopted, the
    next frame renders alone, and each frame equals an eager renderer's
    through the same steps."""
    change, offsets = STEPS[step]
    r = _renderer(progressive=True)
    steps = [None] * 3 + [change] + [None] * 3
    got = _drawn(r, steps)
    assert queued == [k * CFG.spp for k in offsets]
    _assert_same(got, _eager(two_spheres_scene, CFG, monkeypatch, steps))


def test_a_reset_drops_the_queued_frame_at_once(queued):
    r = _renderer(progressive=True)
    for _ in range(2):
        r.draw_frame(0.0)
    assert r._ahead is not None
    r.reset_accumulation()
    assert r._ahead is None and r._ended is None and r._sample_offset == 0
