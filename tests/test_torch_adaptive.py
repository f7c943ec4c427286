"""The port's adaptive spp for the realtime loop (app/adaptive.py) on the
CPU: tests/test_adaptive.py's tests on the port, and ``next_pow2_spp``
equal to the JAX package's over a grid of (spp, noise, target)."""

import itertools

import numpy as np
import pytest
import torch

from csgrenderer_tpu.app import next_pow2_spp as j_next_pow2_spp
from csgrenderer_tpu_torch.app import App, AdaptiveSppRenderer, StatsClock, next_pow2_spp
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.models import two_spheres_scene
from csgrenderer_tpu_torch.utils.config import RenderConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cam():
    return Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=1.5)


def test_ladder_logic():
    # too noisy: up one rung (never more, damping)
    assert next_pow2_spp(4, noise=0.10, target=0.02) == 8
    assert next_pow2_spp(4, noise=1.00, target=0.02) == 8
    # clean enough: down one rung
    assert next_pow2_spp(8, noise=0.005, target=0.02) == 4
    # inside the +-20% hysteresis band: hold
    assert next_pow2_spp(8, noise=0.021, target=0.02) == 8
    assert next_pow2_spp(8, noise=0.017, target=0.02) == 8
    # clamps
    assert next_pow2_spp(1, noise=0.001, target=0.02) == 1
    assert next_pow2_spp(64, noise=9.0, target=0.02, max_spp=64) == 64
    # degenerate measurements hold
    assert next_pow2_spp(4, noise=float("nan"), target=0.02) == 4
    assert next_pow2_spp(4, noise=0.0, target=0.02) == 4


def test_ladder_equals_jax_over_a_grid():
    spps = (1, 2, 3, 4, 8, 16, 64)
    noises = (float("nan"), float("inf"), -1.0, 0.0, 1e-4, 0.004, 0.0159, 0.016, 0.0199, 0.02,
              0.024, 0.0241, 0.03, 0.1, 1.0, 9.0)
    targets = (0.005, 0.02, 0.1)
    for spp, noise, target, (lo, hi) in itertools.product(spps, noises, targets,
                                                          ((1, 64), (2, 16))):
        assert next_pow2_spp(spp, noise, target, lo, hi) == j_next_pow2_spp(
            spp, noise, target, lo, hi), (spp, noise, target, lo, hi)


def test_adaptive_renderer_adapts_and_stays_disjoint():
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=3, seed=0)
    # a very tight target: 2 spp at this size is far noisier, so the
    # controller must climb the ladder after each probe pair
    r = AdaptiveSppRenderer(two_spheres_scene(), _cam(), cfg, target=1e-4, probe_stride=2,
                            device="cpu")
    spps, offsets = [], []
    for _ in range(6):
        img = r.draw_frame(0.0)
        assert tuple(img.shape) == (32, 48, 3)
        spps.append(r.spp)
        offsets.append(r._offset)
    assert spps[-1] >= 8, spps  # climbed at least twice (2 -> 4 -> 8)
    # the shared sample offset strictly advances: disjoint streams across
    # rung switches, every frame a fresh counter range
    assert all(b > a for a, b in zip(offsets, offsets[1:])), offsets
    assert np.isfinite(r.noise)


def test_adaptive_renderer_holds_at_target():
    cfg = RenderConfig(width=48, height=32, spp=4, max_bounces=3, seed=0)
    # a loose target: the measured noise is already below it, so the
    # ladder descends to its bottom rung
    r = AdaptiveSppRenderer(two_spheres_scene(), _cam(), cfg, target=0.5, probe_stride=2,
                            device="cpu")
    for _ in range(6):
        r.draw_frame(0.0)
    assert r.spp == 1


def test_adaptive_renderer_in_the_app_loop_with_frames_in_flight():
    """Through App.run with two frames in flight: the probe frames are
    drawn synchronously, the others asynchronously, and each frame's
    samples follow the last's without a gap or an overlap."""
    cfg = RenderConfig(width=32, height=16, spp=2, max_bounces=2, seed=3)
    r = AdaptiveSppRenderer(two_spheres_scene(), _cam(), cfg, target=1e-4, probe_stride=4,
                            device="cpu")
    spans = []
    inner = r.draw_frame_async

    def recorded(t):
        off0, spp = r._offset, r.spp
        out = inner(t)
        spans.append((off0, r._offset, spp))
        return out

    r.draw_frame_async = recorded
    frames = []
    app = App(frame_sink=lambda i, img: frames.append(np.asarray(img)),
              stats=StatsClock(emit=None))
    app.swap_scene(r)
    assert app.run(max_frames=12, frames_in_flight=2)
    assert len(frames) == 12 and all(f.shape == (16, 32, 3) for f in frames)
    assert all(b - a == s for a, b, s in spans)
    assert all(spans[i + 1][0] == spans[i][1] for i in range(len(spans) - 1))
    assert len({s for _, _, s in spans}) >= 2  # the ladder moved
    assert r.config.spp == r.spp
