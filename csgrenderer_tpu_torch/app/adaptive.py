"""Adaptive samples per pixel for the realtime loop: render to a noise
budget instead of a fixed spp.

Twin of ``csgrenderer_tpu/app/adaptive.py``. The realtime renderer draws
fresh noise every frame (``advance_samples`` moves the counter-based RNG's
sample offset), so two consecutive frames of a static view are an
independent pair at the current spp: their rms difference on the displayed
floats estimates sqrt(2) x the per-frame noise, with no extra render.
Monte-Carlo noise scales as 1/sqrt(spp), so the controller steps the spp
ladder toward ``spp * (noise / target)^2``, one power of two at a time.
Each rung is its own ``PathTraceRenderer``, kept once made; on the card
each rung replays its own frame graph (``app/frame_graph.py``) from its
second frame on, and takes a new camera when it is next drawn.

A probe counts only when the camera and the spp did not change between the
pair's two frames (an orbit drag, app/controls.py, or a rung switch breaks
the pair); otherwise it waits for the next stride.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.config import RenderConfig
from .renderers import PathTraceRenderer, resolve_device


def next_pow2_spp(spp: int, noise: float, target: float, min_spp: int = 1,
                  max_spp: int = 64) -> int:
    """The next spp rung for a measured per-frame ``noise`` against
    ``target``: the ideal spp * (noise / target)^2 rounded to a power of
    two, approached at most one rung per probe (one pair is one sample of
    the noise: damping beats oscillation), and held within +-20% of the
    target (hysteresis)."""
    if not np.isfinite(noise) or noise <= 0.0:
        return spp
    if 0.8 * target <= noise <= 1.2 * target:
        return spp
    ideal = spp * (noise / target) ** 2
    want = 1 << max(0, int(round(np.log2(max(ideal, 1e-9)))))
    if want > spp:
        nxt = spp * 2
    elif want < spp:
        nxt = spp // 2
    else:
        nxt = spp
    return int(min(max(nxt, min_spp), max_spp))


class AdaptiveSppRenderer:
    """An App renderer over one ``PathTraceRenderer(advance_samples=True)``
    per spp rung, all on ``device``.

    All rungs share one sample offset, so the sample streams stay disjoint
    across rung switches (exact under the counter-based RNG, as for
    render_to_noise and the sharded path). The probe reads host pixels on
    the two probe frames of each ``probe_stride``; every other frame of
    ``draw_frame_async`` stays asynchronous.
    """

    def __init__(self, scene, camera, config: RenderConfig, target: float = 0.02,
                 probe_stride: int = 16, min_spp: int = 1, max_spp: int = 64, device="cuda",
                 **renderer_kwargs):
        self._device = resolve_device(device)
        self._scene = scene
        self._camera = camera.to(self._device)
        self._base_cfg = config
        self._kwargs = dict(renderer_kwargs, device=self._device)
        self.target = float(target)
        self.probe_stride = max(2, int(probe_stride))
        self.min_spp = int(min_spp)
        self.max_spp = int(max_spp)
        self._rungs: dict[int, PathTraceRenderer] = {}
        self._stale: set[int] = set()  # rungs that hold an older camera
        self._offset = 0
        self._frame_idx = 0
        self._prev = None  # (host float image / 255, spp, camera id)
        self.spp = int(config.spp)
        self.noise = float("nan")  # the last measured per-frame noise
        self.last_frame_rays = 0

    def _renderer(self, spp: int) -> PathTraceRenderer:
        r = self._rungs.get(spp)
        if r is None:
            cfg = dataclasses.replace(self._base_cfg, spp=spp)
            r = PathTraceRenderer(self._scene, self._camera, cfg, advance_samples=True,
                                  **self._kwargs)
            self._rungs[spp] = r
        elif spp in self._stale:
            r.set_camera(self._camera)
            self._stale.discard(spp)
        r._sample_offset = self._offset
        return r

    @property
    def config(self) -> RenderConfig:
        return dataclasses.replace(self._base_cfg, spp=self.spp)

    def set_camera(self, camera) -> None:
        # moved to the device once here; each rung takes it when next drawn
        self._camera = camera.to(self._device)
        self._stale = set(self._rungs)

    def reset_accumulation(self) -> None:  # the orbit controller's hook
        pass

    def _observe(self, img) -> None:
        """Feed the displayed frame to the probe; move the spp on a pair."""
        self._frame_idx += 1
        probe_phase = self._frame_idx % self.probe_stride
        if probe_phase == 0:
            self._prev = (_host_floats(img), self.spp, id(self._camera))
            return
        if probe_phase == 1 and self._prev is not None:
            prev_img, prev_spp, prev_cam = self._prev
            self._prev = None
            if prev_spp != self.spp or prev_cam != id(self._camera):
                return  # not an independent pair of one view and spp
            cur = _host_floats(img)
            self.noise = float(np.sqrt(np.mean((cur - prev_img) ** 2))) / np.sqrt(2.0)
            self.spp = next_pow2_spp(self.spp, self.noise, self.target, self.min_spp,
                                     self.max_spp)

    def draw_frame(self, time_sec: float):
        r = self._renderer(self.spp)
        img = r.draw_frame(time_sec)
        self._offset = r._sample_offset
        self.last_frame_rays = r.last_frame_rays
        self._observe(img)
        return img

    def draw_frame_async(self, time_sec: float):
        # the probe needs host pixels: its two frames of each stride are
        # drawn synchronously, all others stay asynchronous
        phase = (self._frame_idx + 1) % self.probe_stride
        if phase in (0, 1):
            img = self.draw_frame(time_sec)
            return img, self.last_frame_rays
        r = self._renderer(self.spp)
        img, rays = r.draw_frame_async(time_sec)
        self._offset = r._sample_offset
        self._frame_idx += 1
        return img, rays


def _host_floats(img) -> np.ndarray:
    """A displayed uint8 frame (tensor on any device, or numpy) as host
    floats in [0, 1]."""
    if hasattr(img, "cpu"):
        img = img.cpu().numpy()
    return np.asarray(img, np.float32) / 255.0
