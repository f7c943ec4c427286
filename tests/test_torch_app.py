"""The port's app layer against the JAX package's, on the CPU:
``RenderConfig``, ``Accumulator`` and its npz files, ``write_gif``, the
milestone-01 frame, ``WololoRenderer`` and ``PathTraceRenderer`` (with
``device="cpu"``: the kernels' plain versions) on the goldens, the
per-frame reclustering of animated tapes, render-to-noise, progressive
frames, frames in flight and the App loop.

Goldens are held at the BASELINE criterion of tests/test_golden.py, RMSE
<= 1e-3 on the [0, 1] scale, where it is reachable without XLA's fused
arithmetic (config2 says why not, as tests/test_torch_csg_goldens.py does
for config5).
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.app.renderers import PathTraceRenderer as JPathTraceRenderer
from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.io import checkpoint as jcheckpoint
from csgrenderer_tpu.io.video import write_gif as jwrite_gif
from csgrenderer_tpu.models import two_spheres_scene as j_two_spheres
from csgrenderer_tpu.render import integrator as jintegrator
from csgrenderer_tpu.utils.config import RenderConfig as JRenderConfig
from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock, WololoRenderer
from csgrenderer_tpu_torch.app.goldens import golden_renderers
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.io import checkpoint, read_png, rmse, write_gif
from csgrenderer_tpu_torch.io.checkpoint import Accumulator
from csgrenderer_tpu_torch.models import two_spheres_scene
from csgrenderer_tpu_torch.render import integrator, render_image, tape_hit_adapter
from csgrenderer_tpu_torch.render.tonemap import to_uint8, tonemap
from csgrenderer_tpu_torch.render.trimesh import icosphere
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph
from csgrenderer_tpu_torch.utils.config import RenderConfig, checked

GOLDENS = pathlib.Path(__file__).resolve().parent / "goldens"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cam(aspect=2.0):
    return Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=aspect)


def _jcam(aspect=2.0):
    return JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=aspect)


# --- RenderConfig -----------------------------------------------------------


def test_render_config_matches_jax_and_validates():
    fields = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JRenderConfig)]
    cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=3)
    assert cfg.aspect_ratio == 2.0 and cfg.rays_per_frame == 64 * 32 * 2 * 3
    for bad in (dict(width=0), dict(height=-1), dict(spp=0), dict(max_bounces=0),
                dict(sky="sunset"), dict(denoise_iterations=0)):
        with pytest.raises(ValueError):
            RenderConfig(**bad)
        with pytest.raises(ValueError):
            JRenderConfig(**bad)
    dn = RenderConfig(denoise=True, denoise_iterations=2)
    assert dn == RenderConfig(**{f.name: getattr(JRenderConfig(denoise=True, denoise_iterations=2),
                                                 f.name) for f in dataclasses.fields(dn)})


def test_debug_mode_raises_at_the_first_nan():
    @checked
    def f(x):
        return x / x, torch.tensor(1)

    assert f(torch.ones(2))[1] == 1
    with pytest.raises(FloatingPointError, match="non-finite"):
        f(torch.zeros(2))

    WololoRenderer(RenderConfig(width=8, height=4, spp=1, sky="wololo", debug=True),
                   device="cpu").draw_frame(0.0)  # finite: no error
    cam = _cam()
    pr = PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(width=8, height=4, spp=1,
                                                                  max_bounces=2, debug=True),
                           device="cpu")
    pr.draw_frame(0.0)
    pr.camera = dataclasses.replace(cam, origin=torch.full((3,), float("nan")))
    with pytest.raises(FloatingPointError):
        pr.draw_frame(0.0)


# --- Accumulator, npz checkpoints, GIF ---------------------------------------


def test_accumulator_and_npz_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    a, b = (rng.random((4, 6, 3), dtype=np.float32) for _ in range(2))
    acc = Accumulator.zeros(4, 6).add(torch.from_numpy(a), 2, torch.tensor(100)).add(
        torch.from_numpy(b), 3, 50)
    assert int(acc.sample_count) == 5 and acc.rays_traced == 150
    assert acc.sample_count.dtype == torch.int32
    np.testing.assert_allclose(acc.image().numpy(), (a + b) / 5, rtol=1e-6)
    assert float(Accumulator.zeros(2, 2).image().abs().max()) == 0.0  # n = 0: no NaN

    checkpoint.save(tmp_path / "port.npz", acc, frame=17)
    back, meta = checkpoint.load(tmp_path / "port.npz")
    assert torch.equal(back.radiance_sum, acc.radiance_sum)
    assert int(back.sample_count) == 5 and back.rays_traced == 150 and int(meta["frame"]) == 17
    # the same keys as the JAX package's files, both ways
    jacc, jmeta = jcheckpoint.load(tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(jacc.radiance_sum), acc.radiance_sum.numpy())
    assert int(jacc.sample_count) == 5 and jacc.rays_traced == 150 and int(jmeta["frame"]) == 17
    jcheckpoint.save(tmp_path / "jax.npz", jacc, frame=jnp.int32(3))
    back2, meta2 = checkpoint.load(tmp_path / "jax.npz")
    assert torch.equal(back2.radiance_sum, acc.radiance_sum) and int(meta2["frame"]) == 3


def test_write_gif_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (9, 13, 3), dtype=np.uint8) for _ in range(3)]
    frames.append(np.full((9, 13, 3), 128, np.uint8))  # a gray frame: the gray ramp
    write_gif(tmp_path / "port.gif", frames, fps=7.0)
    jwrite_gif(tmp_path / "jax.gif", frames, fps=7.0)
    assert (tmp_path / "port.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()


# --- config 1: the milestone-01 frame ----------------------------------------


@pytest.mark.parametrize("t_sec", [0.0, 0.25, 1.3])
def test_wololo_frame_matches_jax(t_sec):
    """Within 2 ulp of the JAX frame run op by op; within 1e-5 of it under
    jit, where XLA fuses the arithmetic (4.7e-6 apart at t = 0.25)."""
    got = integrator.render_wololo_frame(t_sec, 64, 48).numpy()
    np.testing.assert_allclose(got, np.asarray(jintegrator.render_wololo_frame(t_sec, 64, 48)),
                               atol=1e-5)
    with jax.disable_jit():
        ref = np.asarray(jintegrator.render_wololo_frame(t_sec, 64, 48))
        ref_st = np.asarray(jintegrator.render_debug_view_1(64, 48))
    np.testing.assert_allclose(got, ref, atol=2.5e-7, rtol=0)
    np.testing.assert_allclose(integrator.render_debug_view_1(64, 48).numpy(), ref_st,
                               atol=1.2e-7, rtol=0)


def _golden(name):
    r, t_sec = golden_renderers("cpu")[name]()
    return r.draw_frame(t_sec).numpy(), read_png(GOLDENS / f"{name}.png")


@pytest.mark.parametrize("name", ["config1_milestone01", "config3_csg_boolean"])
def test_renderer_reproduces_golden(name):
    """tools/make_goldens.py configs 1 (WololoRenderer, 320x240, t = 0.25)
    and 3 (PathTraceRenderer on the CSG tape, 128x128, 8 spp)."""
    img, golden = _golden(name)
    assert img.shape == golden.shape and img.dtype == np.uint8
    assert rmse(img, golden) <= 1e-3


def test_renderer_config2_golden():
    """tools/make_goldens.py config2 (two spheres, 200x112, 8 spp). The
    golden comes from the JAX reference under jit; run op by op
    (``jax.disable_jit()``) the JAX reference itself misses it at RMSE
    1.50e-3, 54 pixels off (XLA's fused arithmetic moves a few paths). The
    port's renderer is within 2 pixels of that unfused render, so the
    bound here is the unfused reference's own distance plus those pixels."""
    img, golden = _golden("config2_two_spheres")
    off = np.abs(img.astype(int) - golden.astype(int)).max(axis=-1) > 0
    assert rmse(img, golden) <= 1.6e-3 and off.sum() <= 56
    cfg = JRenderConfig(width=200, height=112, spp=8, max_bounces=8, seed=2)
    with jax.disable_jit():
        ref = np.asarray(JPathTraceRenderer(j_two_spheres(), _jcam(200 / 112), cfg,
                                            backend="jnp").draw_frame(0.0))
    assert (np.abs(img.astype(int) - ref.astype(int)).max(axis=-1) > 0).sum() <= 2


# --- PathTraceRenderer --------------------------------------------------------


def test_animated_tape_reclusters_per_frame():
    """tests/test_partition.py's recluster test through the port: the
    renderer reclusters the animated tape on a CPU copy each frame; both
    regimes (disjoint: two clusters; overlapping: global) match the plain
    interval-list oracle."""
    g = SceneGraph(max_node_count=8)
    a = g.add_sphere_node(0.5, Material.lambertian((0.7, 0.3, 0.3)))
    b = g.add_sphere_node(0.5, Material.metal((0.8, 0.8, 0.8), 0.2))
    g.add_union_of_node(NA(a, offset=(-2, 0, 0)), NA(b, offset=(2, 0, 0)))
    tape = g.compile(k=2)

    def animate(t, time_sec):
        # slides A from x=-2 (disjoint) to x=+1.5 (overlapping B) over t=0..1
        off = t.edge_off.clone()
        off[0, 0] = -2.0 + 3.5 * time_sec
        return t.with_edges(t.edge_quat, off)

    cam = Camera.look_at((0, 1.0, 5.0), (0, 0, 0), vfov_degrees=50.0, aspect_ratio=2.0)
    r = PathTraceRenderer(tape, cam, RenderConfig(width=32, height=16, spp=2, max_bounces=3,
                                                  seed=7), animate=animate, device="cpu")
    c0, c1, c2 = r._recluster(0.0), r._recluster(0.1), r._recluster(1.0)
    assert len(c0) == 2 and c0 == c1  # moved but same clustering -> equal
    assert c2 == ()  # overlapping: nothing splits -> global evaluation
    for t_sec in (0.0, 1.0):
        got = r.draw_frame(t_sec).numpy()
        ref, _ = render_image(functools.partial(tape_hit_adapter, animate(tape, t_sec)), cam, 32,
                              16, spp=2, max_bounces=3, seed=7)
        ref8 = to_uint8(tonemap(ref, gamma=2.0)).numpy()
        bad = (np.abs(got.astype(int) - ref8.astype(int)).max(axis=-1) > 12).mean()
        assert bad <= 0.02, f"t={t_sec}: {bad:.3%} divergent"


def test_render_to_noise_matches_jax():
    """Two spheres at 64x32, 8-spp chunks, target 5e-3: the same samples
    used as JAX's jnp renderer and the same measured noise within rel 2e-3
    (measured 1.1e-3 apart: under jit XLA's fused arithmetic moves a few
    silhouette paths, as on config2's golden, and each moves the estimate)."""
    cfg = dict(width=64, height=32, spp=8, max_bounces=3, seed=9)
    jr = JPathTraceRenderer(j_two_spheres(), _jcam(), JRenderConfig(**cfg), backend="jnp")
    _, j_noise, j_used = jr.render_to_noise(target=5e-3, max_spp=4096)
    r = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(**cfg), device="cpu",
                          progressive=True)
    acc, noise, used = r.render_to_noise(target=5e-3, max_spp=4096)
    assert used == j_used and noise <= 5e-3
    assert noise == pytest.approx(j_noise, rel=2e-3)
    assert int(acc.sample_count) == used == r._sample_offset
    assert int(r.accumulator.sample_count) == used
    # the merged two streams are one uniform render over [0, used)
    ref, ref_rays = render_image(two_spheres_scene().nearest_hit, _cam(), 64, 32, spp=used,
                                 max_bounces=3, seed=9)
    np.testing.assert_allclose(acc.image().numpy(), ref.numpy(), atol=2e-6)
    assert acc.rays_traced == int(ref_rays)
    # an unreachable target runs to max_spp and says so
    r2 = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(**cfg), device="cpu")
    _, noise2, used2 = r2.render_to_noise(target=1e-9, max_spp=32)
    assert used2 == 32 and noise2 > 1e-9


def test_progressive_frames_equal_jax():
    cfg = dict(width=48, height=24, spp=2, max_bounces=3, seed=1)
    jr = JPathTraceRenderer(j_two_spheres(), _jcam(), JRenderConfig(**cfg), backend="jnp",
                            progressive=True)
    r = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(**cfg), device="cpu",
                          progressive=True)
    for _ in range(3):
        ref = np.asarray(jr.draw_frame(0.0))
        got = r.draw_frame(0.0).numpy()
        assert (np.abs(got.astype(int) - ref.astype(int)).max(axis=-1) > 1).sum() <= 1
        assert r.last_frame_rays == jr.last_frame_rays
    assert int(r.accumulator.sample_count) == int(jr.accumulator.sample_count) == 6
    with pytest.raises(ValueError, match="synchronous"):
        r.draw_frame_async(0.0)


def test_renderer_refusals():
    cam = _cam()
    scene = two_spheres_scene()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PathTraceRenderer(scene, cam, RenderConfig(width=8, height=4))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WololoRenderer(RenderConfig(width=8, height=4))
    with pytest.raises(ValueError, match="progressive"):
        PathTraceRenderer(scene, cam, RenderConfig(), device="cpu", progressive=True,
                          advance_samples=True)
    with pytest.raises(ValueError, match="no emissive"):
        PathTraceRenderer(scene, cam, RenderConfig(nee=True), device="cpu")
    with pytest.raises(NotImplementedError, match="nee \\+ animate"):
        PathTraceRenderer(scene, cam, RenderConfig(nee=True), device="cpu",
                          animate=lambda s, t: s)
    with pytest.raises(TypeError, match="unsupported"):
        PathTraceRenderer(object(), cam, RenderConfig(), device="cpu")
    with pytest.raises(ValueError, match="entry point"):
        WololoRenderer(RenderConfig(), entry_point="rt9", device="cpu")


# --- frames in flight and the App loop (tests/test_frames_in_flight.py,
# tests/test_app_integration.py) ----------------------------------------------


class RecordingRenderer:
    """Logs dispatch/consume interleaving via a lazily-read array wrapper."""

    def __init__(self, log):
        self.log = log
        self.last_frame_rays = 1

    def draw_frame_async(self, t):
        idx = len([e for e in self.log if e[0] == "dispatch"])
        self.log.append(("dispatch", idx))
        outer = self

        class Lazy:
            def __array__(self, dtype=None, copy=None):
                outer.log.append(("consume", idx))
                return np.zeros((2, 2, 3), np.uint8)

        return Lazy(), 1

    def draw_frame(self, t):
        self.log.append(("dispatch-sync", None))
        return np.zeros((2, 2, 3), np.uint8)


def test_dispatch_precedes_consume_with_two_in_flight():
    log = []
    app = App(frame_sink=lambda i, img: None, stats=StatsClock(emit=None))
    app.swap_scene(RecordingRenderer(log))
    assert app.run(max_frames=4, frames_in_flight=2)
    order = [e for e in log if e[0] in ("dispatch", "consume")]
    assert order[:5] == [("dispatch", 0), ("dispatch", 1), ("consume", 0), ("dispatch", 2),
                         ("consume", 1)]
    assert [i for (k, i) in order if k == "consume"] == [0, 1, 2, 3]


def test_pipelined_output_matches_serial():
    cfg = RenderConfig(width=32, height=32, spp=2, max_bounces=4, seed=7)

    def collect(in_flight):
        frames = {}
        app = App(frame_sink=lambda i, img: frames.__setitem__(i, np.asarray(img)),
                  stats=StatsClock(emit=None))
        app.swap_scene(PathTraceRenderer(two_spheres_scene(), _cam(1.0), cfg, device="cpu"))
        fixed = iter(np.arange(0.0, 100.0, 0.125))  # deterministic clock
        assert app.run(max_frames=3, frames_in_flight=in_flight,
                       time_fn=lambda: float(next(fixed)))
        return frames

    serial, piped = collect(1), collect(2)
    assert sorted(serial) == sorted(piped) == [0, 1, 2]
    for i in serial:
        np.testing.assert_array_equal(serial[i], piped[i])


def _run_app(renderer, frames=2):
    captured = []
    app = App(target_updates_per_sec=30.0, width=renderer.config.width,
              height=renderer.config.height, caption="it",
              init_cb=lambda app, w, h, cap, dt: (app.swap_scene(renderer), True)[1],
              frame_sink=lambda i, img: captured.append(np.asarray(img)),
              stats=StatsClock(emit=None))
    assert app.run(max_frames=frames)
    return captured


def test_renderers_through_the_app_loop():
    wo = WololoRenderer(RenderConfig(width=64, height=48, spp=1, sky="wololo"), device="cpu")
    frames = _run_app(wo, frames=3)
    assert len(frames) == 3 and all(f.shape == (48, 64, 3) and f.dtype == np.uint8
                                    for f in frames)
    pt = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(width=64, height=32, spp=1,
                                                                     max_bounces=3, seed=1),
                           device="cpu")
    frames = _run_app(pt)
    assert len(frames) == 2 and pt.last_frame_rays > 0
    np.testing.assert_array_equal(frames[0], frames[1])  # static scene and seed
    prog = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(width=48, height=24, spp=2,
                                                                       max_bounces=3, seed=1),
                             device="cpu", progressive=True)
    frames = _run_app(prog, frames=3)
    assert int(prog.accumulator.sample_count) == 6
    d01 = np.abs(frames[0].astype(int) - frames[1].astype(int)).mean()
    d12 = np.abs(frames[1].astype(int) - frames[2].astype(int)).mean()
    assert 0 < d01 and d12 <= d01 + 1e-9
    mesh = icosphere((0, 0, -4), 1.0, Material.lambertian((0.6, 0.3, 0.3)), 1)
    cam = Camera.look_at((0, 0, 0), (0, 0, -4), vfov_degrees=45, aspect_ratio=2.0)
    mr = PathTraceRenderer(mesh, cam, RenderConfig(width=64, height=32, spp=1, max_bounces=3,
                                                   seed=1), device="cpu")
    frames = _run_app(mr)
    assert len(frames) == 2 and mr.last_frame_rays > 0
    np.testing.assert_array_equal(frames[0], frames[1])


def test_time_fn_and_trace(tmp_path):
    """``profiling.trace`` writes the profiler's events and, on a thread of
    their own and the same time base, the program's spans of its block."""
    import json

    from csgrenderer_tpu_torch.utils import profiling

    r = PathTraceRenderer(two_spheres_scene(), _cam(), RenderConfig(width=16, height=8, spp=1,
                                                                    max_bounces=2), device="cpu")
    r.draw_frame(0.0)
    with profiling.trace(str(tmp_path / "trace")):
        r.draw_frame(0.0)
    doc = json.loads((tmp_path / "trace" / "trace.json").read_text())
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans] == ["render.frame", "render.launch", "render.tonemap",
                                          "render.fence"]
    assert {e["tid"] for e in spans} == {profiling.SPAN_TID}
    assert {"ph": "M", "name": "thread_name", "pid": spans[0]["pid"], "tid": profiling.SPAN_TID,
            "args": {"name": profiling.SPAN_THREAD}} in events
    frame, launch = spans[0], spans[1]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"
           and launch["ts"] <= e["ts"] and e["ts"] + e["dur"] <= launch["ts"] + launch["dur"]]
    assert ops  # the profiler's operations of the launch lie inside its span
    assert all(frame["ts"] <= e["ts"] <= frame["ts"] + frame["dur"] for e in spans)
    assert profiling.spans() and profiling.span("render.launch") is profiling.OFF
