"""Each fault a cell can have, planted under the timed path, makes the
run's ``correct`` come out false; the look for a card is the only part of
a run these skip. (The cells run on one card: no exchange between chips
exists to leave out.)"""

import dataclasses

import benchmark_cpu
import pytest

from benchmark import harness
from csgrenderer_tpu_torch.app import renderers
from csgrenderer_tpu_torch.io.checkpoint import Accumulator


def state_unchanged(mp):
    """A step that returns its state unchanged: the accumulation never
    grows; a live frame never advances its samples."""
    mp.setattr(Accumulator, "add", lambda self, radiance, samples, rays: self)
    orig = renderers.PathTraceRenderer.draw_frame_async

    def stuck(self, t):
        offset = self._sample_offset
        out = orig(self, t)
        self._sample_offset = offset
        return out

    mp.setattr(renderers.PathTraceRenderer, "draw_frame_async", stuck)


def half_batch(mp):
    """Half of each pixel's samples left out, the mean taken over the rest."""
    orig = renderers._render_kernel

    def half(scene, camera, cfg, sample_base, **kw):
        return orig(scene, camera, dataclasses.replace(cfg, spp=max(1, cfg.spp // 2)),
                    sample_base, **kw)

    mp.setattr(renderers, "_render_kernel", half)


def answer_altered(mp):
    """The radiance altered where the kernel produces it."""
    orig = renderers._render_kernel

    def altered(*args, **kw):
        radiance, rays = orig(*args, **kw)
        return radiance * radiance.new_tensor([1.25, 1.0, 1.0]), rays

    mp.setattr(renderers, "_render_kernel", altered)


def rays_inflated(mp):
    """The segment count, the numerator of Mrays/s, altered where produced."""
    orig = renderers._render_kernel

    def inflated(*args, **kw):
        radiance, rays = orig(*args, **kw)
        return radiance, rays + rays // 50 + 1

    mp.setattr(renderers, "_render_kernel", inflated)


OFFLINE = (state_unchanged, half_batch, answer_altered, rays_inflated)
CASES = ([("rtiow-offline-1080p64", f) for f in OFFLINE]
         + [("deepcsg-progressive-4k2", f) for f in OFFLINE]
         + [("rtiow-realtime-denoised-720p2", f) for f in (state_unchanged, half_batch,
                                                            answer_altered)])


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    run = benchmark_cpu.tiny_run(cell)
    line = harness.result(run)
    assert line["correct"] is False, line["checks"]
