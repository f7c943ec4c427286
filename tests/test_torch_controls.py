"""The port's interactive input path (app/controls.py) on the CPU:
tests/test_controls.py's tests on the port (the orbit rig's math, its
event handling, and the browser -> App -> renderer wiring), and the rig's
cameras against the JAX package's."""

import math

import numpy as np
import pytest
import torch

from csgrenderer_tpu.app.controls import OrbitController as JOrbitController
from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock
from csgrenderer_tpu_torch.app.controls import OrbitController, attach
from csgrenderer_tpu_torch.app.preview import PreviewServer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.render.integrator import SphereScene
from csgrenderer_tpu_torch.utils.config import RenderConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_scene():
    return SphereScene(
        centers=torch.tensor([(0.0, 0.0, -3.0), (0.0, -100.5, -3.0)]),
        radii=torch.tensor([0.5, 100.0]),
        mat_kind=torch.zeros((2,), dtype=torch.int32),
        albedo=torch.tensor([(0.7, 0.3, 0.3), (0.5, 0.5, 0.5)]),
        mat_param=torch.zeros((2,)),
    )


def test_from_camera_reproduces_pose():
    lookfrom, lookat = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0)
    rig = OrbitController.from_camera(lookfrom, lookat, vfov_degrees=20.0, aspect_ratio=2.0,
                                      aperture=0.1, focus_dist=10.0)
    ref = Camera.look_at(lookfrom, lookat, vfov_degrees=20.0, aspect_ratio=2.0, aperture=0.1,
                         focus_dist=10.0)
    got = rig.camera()
    for name in ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name).numpy(),
                                   atol=1e-5)


def test_rig_matches_jax():
    """The same events through both rigs: the same angles, and cameras
    within 1e-5."""
    kw = dict(vfov_degrees=32.0, aspect_ratio=16 / 9, aperture=0.0, focus_dist=None)
    rig = OrbitController.from_camera((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), **kw)
    jrig = JOrbitController.from_camera((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), **kw)
    events = [{"type": "orbit", "dyaw": "0.3", "dpitch": "-0.1"}, {"type": "key", "code": "+"},
              {"type": "key", "code": "ArrowUp"}, {"type": "orbit", "dzoom": "0.5"}]
    for ev in events:
        assert rig.handle(ev) == jrig.handle(ev)
        assert (rig.yaw, rig.pitch, rig.distance) == (jrig.yaw, jrig.pitch, jrig.distance)
    got, ref = rig.camera(), jrig.camera()
    for name in ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5)


def test_orbit_events_move_the_eye():
    rig = OrbitController(target=(0, 0, 0), distance=5.0, yaw=0.0, pitch=0.0)
    o0 = rig.camera().origin.numpy()
    assert rig.handle({"type": "orbit", "dyaw": str(math.pi / 2)}) is None
    o1 = rig.camera().origin.numpy()
    assert np.linalg.norm(o1 - o0) > 1.0
    np.testing.assert_allclose(np.linalg.norm(o1), 5.0, atol=1e-5)
    # pitch clamps off the pole, distance at its minimum
    rig.handle({"type": "orbit", "dpitch": "99"})
    assert rig.pitch < math.pi / 2
    rig.handle({"type": "orbit", "dzoom": "-999"})
    assert rig.distance == rig.min_distance
    # key steps and the close analogs
    assert rig.handle({"type": "key", "code": "ArrowLeft"}) is None
    assert rig.handle({"type": "key", "code": "Escape"}) == "close"
    assert rig.handle({"type": "close"}) == "close"
    assert rig.handle({"type": "key", "code": "x"}) is None  # unbound: nothing


def test_attach_drives_renderer_and_stops_on_close():
    """End to end: events pushed at the server move the renderer's camera
    inside App.run (the next frame packs the new camera), and a close
    event stops the loop before max_frames."""
    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=2, seed=1)
    cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=60.0, aspect_ratio=2.0)
    r = PathTraceRenderer(_tiny_scene(), cam, cfg, device="cpu")
    srv = PreviewServer(port=0)  # never started: the queue alone
    rig = OrbitController.from_camera((0, 0, 1), (0, 0, -3), vfov_degrees=60.0,
                                      aspect_ratio=2.0)
    # a huge update rate: the fixed-timestep accumulator fires update_cb on
    # every loop iteration however fast the tiny frames render
    app = App(target_updates_per_sec=100000.0, width=16, height=8, stats=StatsClock(emit=None))
    app.swap_scene(r)
    attach(app, r, srv, rig)

    img0 = r.draw_frame(0.0).numpy()
    srv.push_event({"type": "orbit", "dyaw": "1.2"})
    frames = []
    app.frame_sink = lambda i, img: frames.append(np.asarray(img))
    assert app.run(max_frames=3)
    assert r.camera is not cam and not torch.equal(r.camera.origin, cam.origin)
    assert any(not np.array_equal(f, img0) for f in frames)

    srv.push_event({"type": "close"})
    count = []
    app.frame_sink = lambda i, img: count.append(i)
    assert app.run(max_frames=1000)
    assert len(count) < 1000  # stopped by the event, not the frame cap


def test_attach_chains_an_existing_update_callback():
    calls = []
    app = App(update_cb=lambda a, dt: calls.append("prior"))
    srv = PreviewServer(port=0)
    rig = OrbitController(distance=4.0)
    r = PathTraceRenderer(_tiny_scene(), rig.camera(), RenderConfig(width=8, height=4, spp=1,
                                                                    max_bounces=1), device="cpu")
    cb = attach(app, r, srv, rig)
    assert app.update_cb is cb
    srv.push_event({"type": "key", "code": "ArrowRight"})
    cb(app, 1 / 60)
    assert calls == ["prior"] and not rig.dirty
