"""When ``PathTraceRenderer`` replays a frame from a CUDA graph, on the CPU:
when a graph is captured and kept, that the config it bakes in is fixed
for the renderer's life, the sample offsets each frame renders at, the
view a graph is given, the offset word a replay writes and the launch
counters a replay adds to. Which renderers replay is the one decision
tested in tests/test_torch_prelaunch.py. The graph itself needs the card
(tests/test_torch_cuda.py); here ``FrameGraph`` is stood in for by objects
that record what the renderer asks of them, or that replay nothing."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from csgrenderer_tpu_torch.app import (AdaptiveSppRenderer, PathTraceRenderer, frame_graph,
                                       renderers)
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import atrous, build, shard_canary, tape_kernel, trimesh_kernel
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.models import two_spheres_scene
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph
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


def _renderer(scene=None, cfg=CFG, **kw):
    return PathTraceRenderer(two_spheres_scene() if scene is None else scene, _cam(), cfg,
                             device="cpu", **kw)


class FakeGraph:
    """Stands in for ``FrameGraph``: records the offsets it replays at and
    the views it is given, and returns a frame that names its offset."""

    made = []

    def __init__(self, body, device, spp, size, camera):
        self.spp, self.size, self.offsets, self.views = spp, size, [], [camera]
        FakeGraph.made.append(self)

    def set_camera(self, camera):
        self.views.append(camera)

    def replay(self, sample_offset):
        self.offsets.append(sample_offset)
        return torch.full((4, 8, 3), len(self.offsets), dtype=torch.uint8), torch.tensor(7)


@pytest.fixture
def fake_card(monkeypatch):
    """Renderers made from here on decide how their frames run as if on the
    card; graphs are captured as ``FakeGraph``s."""
    FakeGraph.made = []
    schedule = renderers.frame_schedule
    monkeypatch.setattr(renderers, "frame_schedule", lambda device, *a: schedule(CARD, *a))
    monkeypatch.setattr(frame_graph, "FrameGraph", FakeGraph)
    return FakeGraph.made


def test_cpu_frames_never_capture():
    captures = frame_graph.CAPTURES
    for r in (_renderer(advance_samples=True), _renderer(_tape())):
        r.draw_frame(0.0)
        r.draw_frame_async(0.0)
        r.draw_frame_async(0.1)
        assert r._graph is None
    assert frame_graph.CAPTURES == captures


def test_eager_offsets_advance_by_spp_a_frame():
    r = _renderer(advance_samples=True)
    images = [r.draw_frame_async(0.0)[0] for _ in range(3)]
    assert r._sample_offset == 3 * CFG.spp
    r.draw_frame(0.0)
    assert r._sample_offset == 4 * CFG.spp
    fixed = _renderer()
    first = fixed.draw_frame_async(0.0)[0]
    fixed.draw_frame_async(0.0)
    assert fixed._sample_offset == 0
    assert torch.equal(first, images[0])  # both rendered at offset 0
    assert not torch.equal(images[0], images[1])  # fresh noise each frame


def test_capture_follows_one_eager_frame_and_replays_at_each_offset(fake_card):
    r = _renderer(advance_samples=True)
    eager = r.draw_frame_async(0.0)[0]
    assert not fake_card and r._sample_offset == CFG.spp
    outs = [r.draw_frame_async(0.1 * i) for i in range(4)]
    assert len(fake_card) == 1 and r._graph is fake_card[0]
    assert fake_card[0].spp == CFG.spp and fake_card[0].size == (CFG.height, CFG.width)
    assert fake_card[0].offsets == [CFG.spp * k for k in range(1, 5)]
    assert [int(img[0, 0, 0]) for img, _ in outs] == [1, 2, 3, 4]
    assert eager.dtype == torch.uint8 and int(outs[0][1]) == 7
    assert r.draw_frame(0.0)[0, 0, 0] == 5 and r.last_frame_rays == 7
    assert fake_card[0].offsets[-1] == 5 * CFG.spp and r._sample_offset == 6 * CFG.spp
    r.reset_accumulation()
    r.draw_frame_async(0.0)
    assert fake_card[0].offsets[-1] == 0 and len(fake_card) == 1


def test_without_advance_every_replay_takes_the_same_offset(fake_card):
    r = _renderer(sample_offset=10)
    for _ in range(4):
        r.draw_frame_async(0.0)
    assert fake_card[0].offsets == [10, 10, 10]


def test_progressive_draw_frame_never_asks_for_a_graph(fake_card):
    r = _renderer(progressive=True)
    r.draw_frame(0.0)
    r.draw_frame(0.0)
    assert not fake_card and r._sample_offset == 2 * CFG.spp


def _captured(r):
    """``r`` holding a captured graph (a ``FrameGraph`` with nothing on the
    card), its camera row on the CPU."""
    g = object.__new__(frame_graph.FrameGraph)
    g.camera = mk.pack_camera(r.camera)
    r._graph = g
    return g


def test_set_camera_writes_the_new_view_into_the_graph():
    """The graph reads its view from its own camera row: ``set_camera``
    keeps the graph and rewrites the row in place."""
    r = _renderer()
    g = _captured(r)
    row = g.camera
    r.set_camera(_cam(0.5))
    assert r._graph is g and g.camera is row
    assert torch.equal(row, mk.pack_camera(_cam(0.5)))
    assert not torch.equal(row, mk.pack_camera(_cam()))


def test_config_is_fixed_for_the_renderers_life():
    """The pack and a captured graph bake the config in: assigning another
    raises, and leaves the config, the pack and the graph as they were."""
    r = _renderer()
    g = _captured(r)
    config, packed = r.config, r._packed
    with pytest.raises(AttributeError, match="make a new renderer"):
        r.config = dataclasses.replace(r.config, spp=4)
    assert r.config is config and r._packed is packed and r._graph is g


def test_set_camera_keeps_the_graph_and_a_config_swap_runs_an_eager_frame_first(fake_card):
    r = _renderer(advance_samples=True)
    for _ in range(3):
        r.draw_frame_async(0.0)
    assert len(fake_card) == 1 and fake_card[0].views == [r.camera]
    r.set_camera(_cam(0.5))
    r.draw_frame_async(0.0)  # the same graph, at the new view
    assert len(fake_card) == 1 and fake_card[0].views[-1] is r.camera
    assert fake_card[0].offsets[-1] == 3 * CFG.spp
    r.camera = _cam(1.0)  # as set_camera
    r.draw_frame_async(0.0)
    assert len(fake_card) == 1 and fake_card[0].views[-1] is r.camera
    assert fake_card[0].offsets[-1] == 4 * CFG.spp


def test_an_adaptive_rung_takes_a_new_camera_when_next_drawn(monkeypatch):
    """The adaptive ladder hands the camera to a rung only when it changed
    since that rung last took one, so a rung's graph is rewritten once a
    view."""
    calls = []
    set_camera = PathTraceRenderer.set_camera
    monkeypatch.setattr(PathTraceRenderer, "set_camera",
                        lambda self, cam: (calls.append((self.config.spp, cam)),
                                           set_camera(self, cam)))
    a = AdaptiveSppRenderer(two_spheres_scene(), _cam(), CFG, device="cpu")
    two = a._renderer(2)
    four = a._renderer(4)
    a._renderer(2)
    assert not calls
    a.set_camera(_cam(0.5))
    assert a._renderer(2) is two and a._renderer(2) is two
    assert [spp for spp, _ in calls] == [2] and calls[0][1] is a._camera
    a._renderer(4)
    assert [spp for spp, _ in calls] == [2, 4] and four.camera.origin is a._camera.origin


def test_every_kernel_module_registers_its_launch_counters():
    registered = {(m, name) for m, name in build.LAUNCH_COUNTERS}
    for module in (mk, tape_kernel, trimesh_kernel, atrous, shard_canary):
        names = {n for n in vars(module) if n.startswith("LAUNCHES")}
        assert names and {(module, n) for n in names} <= registered, module.__name__


def test_replays_count_the_captured_launches_once_each():
    """A capture's launches, taken back from the counters, are added once a
    replay: the difference of two readings of ``build.launch_counts``."""
    before = build.launch_counts()
    mk.LAUNCHES += 2
    mk.LAUNCHES_BY_MODE["grid"] += 1
    mk.LAUNCHES_BY_MODE["gbuffer"] += 1
    atrous.LAUNCHES += 4
    atrous.LAUNCHES_BY_MODE["pass"] += 4
    after = build.launch_counts()
    delta = {k: n - before[k] for k, n in after.items() if n != before[k]}
    assert delta == {(mk, "LAUNCHES", None): 2, (mk, "LAUNCHES_BY_MODE", "grid"): 1,
                     (mk, "LAUNCHES_BY_MODE", "gbuffer"): 1, (atrous, "LAUNCHES", None): 4,
                     (atrous, "LAUNCHES_BY_MODE", "pass"): 4}
    build.add_launch_counts({k: -n for k, n in delta.items()})
    assert build.launch_counts() == before
    build.add_launch_counts(delta)
    assert build.launch_counts() == after
    build.add_launch_counts({k: -n for k, n in delta.items()})


class _Word:
    """Stands in for the one-word offset tensor: counts the host's writes."""

    def __init__(self):
        self.value, self.fills = 0, 0

    def fill_(self, value):
        self.value, self.fills = value, self.fills + 1


def _replaying(h=4, w=8, spp=2, rays=7):
    """A ``FrameGraph`` over CPU buffers whose replay runs what the captured
    graph does to the offset word (it adds spp) and records the word it
    read; its frame holds the bytes 0, 1, 2, ... and ``rays``."""
    g = object.__new__(frame_graph.FrameGraph)
    g.spp = spp
    g.offset, g._word, g.launches, g.read = _Word(), 0, {}, []

    def run():
        g.read.append(g.offset.value)
        g.offset.value = frame_graph._as_int32(g.offset.value + spp)

    g.graph = SimpleNamespace(replay=run)
    n = h * w * 3
    g.out = torch.zeros(-(-n // 8) * 8 + 8, dtype=torch.uint8)
    g.out[:n] = torch.arange(n) % 251
    g.out.view(torch.int64)[-1] = rays
    g._image = ((h, w, 3), (w * 3, 3, 1))
    return g


def test_a_replay_writes_the_offset_word_only_when_the_graph_did_not_advance_it():
    g = _replaying()
    offsets = [0, 2, 4, 6, 0, 2, 10, 10, 10, 2**32 - 2, 2**32, 2**32 + 2]
    for offset in offsets:
        g.replay(offset)
    assert g.read == [frame_graph._as_int32(o) for o in offsets]
    # written at the reset to 0, at 10 and twice more (no advance), at 2**32 - 2
    assert g.offset.fills == 5


def test_a_replay_returns_copies_of_the_image_and_the_rays():
    g = _replaying(h=3, w=5, rays=2**40 + 3)
    replays = frame_graph.REPLAYS
    image, rays = g.replay(0)
    assert frame_graph.REPLAYS == replays + 1
    assert image.shape == (3, 5, 3) and image.dtype == torch.uint8 and image.is_contiguous()
    assert torch.equal(image.flatten(), torch.arange(45, dtype=torch.uint8))
    assert rays.shape == () and rays.dtype == torch.int64 and int(rays) == 2**40 + 3
    assert image.data_ptr() != g.out.data_ptr()
    g.out.zero_()
    assert int(image[2, 4, 2]) == 44 and int(rays) == 2**40 + 3


@pytest.mark.parametrize("offset, word", [(0, 0), (5, 5), (2**31 - 1, 2**31 - 1),
                                          (2**31, -2**31), (2**32 - 1, -1), (2**32 + 6, 6)])
def test_the_offset_word_holds_the_low_32_bits(offset, word):
    assert frame_graph._as_int32(offset) == word
    assert torch.tensor([word], dtype=torch.int32).view(torch.uint32).item() == offset % 2**32
