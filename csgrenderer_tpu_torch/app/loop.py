"""Host-side render loop — the headless ``wo_app``.

Twin of ``csgrenderer_tpu/app/loop.py``. Frames in flight rest on the
kernels launching asynchronously on the current CUDA stream: a renderer's
``draw_frame_async`` returns device tensors at once, and the loop reads a
frame back (``.cpu().numpy()``, or in "fence" mode ``int(rays)``) only
when the sink consumes it.

Re-expresses the reference's app layer (``src/wololo/app.{h,c}``) for a
headless accelerator world:

- ``App`` mirrors ``wo_app_new`` (target updates/sec, size, caption,
  init/update/deinit callbacks, ``app.h:24-31``) and ``wo_app_run``'s
  fixed-timestep lag-accumulator loop (``app.c:136-154``): update callbacks
  fire at a fixed simulation rate however long frames take.
- The window/present half of the reference collapses into a frame *sink*
  (save PNGs, accumulate, stream — any callable), and the GPU submit/fence
  machinery collapses into asynchronous launches: ``draw_frame_async``
  returns device tensors that are still being computed; the loop only
  blocks when the sink consumes them.
  (The reference instead blocked every frame on ``vkQueueWaitIdle``,
  renderer.c:2212 — the quirk we deliberately do NOT reproduce.)
- The singleton assert (``app.c:54``) is dropped: Apps are plain objects.

A "scene renderer" is anything with ``draw_frame(time_sec) -> image`` —
see demos/ for concrete ones; ``wo_app_swap_scene`` becomes ``swap_scene``.

Each iteration reads whether spans record (``utils/profiling.poll``), and
the readback that blocks on a consumed frame is the span ``app.readback``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import profiling
from .stats import StatsClock


@dataclass
class App:
    target_updates_per_sec: float = 60.0
    width: int = 1280
    height: int = 720
    caption: str = "csgr"
    init_cb: Optional[Callable] = None  # (app, w, h, caption, target_frame_time)->bool
    update_cb: Optional[Callable] = None  # (app, dt_sec)
    deinit_cb: Optional[Callable] = None  # (app,)
    frame_sink: Optional[Callable] = None  # (frame_index, image)->None
    stats: StatsClock = field(default_factory=StatsClock)

    _renderer: object = None
    _running: bool = False

    def swap_scene(self, renderer) -> None:
        """== wo_app_swap_scene (app.c:216): installs the active renderer."""
        self._renderer = renderer

    @property
    def renderer(self):
        return self._renderer

    def stop(self) -> None:
        self._running = False

    def run(
        self,
        max_frames: Optional[int] = None,
        max_seconds: Optional[float] = None,
        time_fn: Callable[[], float] = time.monotonic,
        frames_in_flight: int = 1,
        readback: str = "full",
        fence_stride: int = 1,
    ) -> bool:
        """Fixed-timestep loop (app.c:74-214 semantics, headless).

        ``frames_in_flight > 1`` pipelines: frame N+1 is DISPATCHED (kernels
        enqueued via the renderer's ``draw_frame_async``) before frame N's
        device->host readback is consumed by the sink, so compute overlaps
        readback/host work — the working version of the reference's
        2-frames-in-flight sync objects that its per-frame vkQueueWaitIdle
        neutralized (renderer.c:51, 1742-1798, 2212).

        ``readback`` (pipelined mode only):
        - "full": transfer each frame to host numpy before the sink (the
          default; what an encoder/disk sink needs).
        - "fence": hand the sink the DEVICE tensor and only synchronize
          with a scalar readback every ``fence_stride``-th frame — the
          headless analog of presenting on-device without a host copy
          (the reference's present never copies to host either). Use when
          the consumer can sample frames (preview ring, periodic encode).

        Returns True on clean completion (init returning False aborts, like
        the reference's ``wo_app_run`` failure path).
        """
        update_dt = 1.0 / self.target_updates_per_sec
        if self.init_cb is not None:
            ok = self.init_cb(self, self.width, self.height, self.caption, update_dt)
            if not ok:
                return False
        if self._renderer is None:
            # The reference would crash on a NULL renderer in frame 1
            # (SURVEY §3.1); we fail cleanly instead.
            if self.deinit_cb is not None:
                self.deinit_cb(self)
            return False

        pipelined = frames_in_flight > 1 and hasattr(
            self._renderer, "draw_frame_async"
        )

        self._running = True
        start = time_fn()
        prev = start
        lag = 0.0
        frame = 0
        pending: list = []  # (frame_idx, image_future, rays_future)
        last_consume = start

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        def consume(entry):
            nonlocal last_consume
            idx, image, rays = entry

            fence_frame = idx % max(fence_stride, 1) == 0
            if readback == "full":
                with profiling.span("app.readback"):
                    out = host(image)  # blocks until the frame is ready
            else:  # "fence": ONE scalar sync every fence_stride frames —
                # the rays counter is a dependent output of the same frame,
                # so reading it IS the fence
                if fence_frame and not isinstance(rays, int):
                    pass  # synced via int(rays) below
                elif fence_frame:
                    with profiling.span("app.readback"):
                        host(image[0, 0])
                out = image  # device tensor: sink samples/keeps references
            if self.frame_sink is not None:
                self.frame_sink(idx, out)
            # a device-scalar rays readback is itself a sync: only force it
            # when we already synced
            if isinstance(rays, int):
                n_rays = rays
            elif readback == "full":
                n_rays = int(rays)
            elif fence_frame:
                with profiling.span("app.readback"):
                    n_rays = int(rays)
            else:
                n_rays = 0
            now2 = time_fn()
            self.stats.frame(now2 - last_consume, rays=n_rays, now=now2)
            last_consume = now2

        try:
            while self._running:
                profiling.poll()
                now = time_fn()
                elapsed, prev = now - prev, now
                lag += elapsed

                # fixed-timestep updates (app.c:151-154)
                while lag >= update_dt:
                    if self.update_cb is not None:
                        self.update_cb(self, update_dt)
                    lag -= update_dt

                t_sim = now - start
                if pipelined:
                    image, rays = self._renderer.draw_frame_async(t_sim)
                    pending.append((frame, image, rays))
                    # consume the oldest once the pipe is full: the device
                    # is already computing the frames dispatched above
                    while len(pending) >= frames_in_flight:
                        consume(pending.pop(0))
                else:
                    image = self._renderer.draw_frame(t_sim)
                    if self.frame_sink is not None:
                        self.frame_sink(frame, image)
                    frame_dt = time_fn() - now
                    rays = getattr(self._renderer, "last_frame_rays", 0)
                    self.stats.frame(frame_dt, rays=int(rays), now=time_fn())
                frame += 1

                if max_frames is not None and frame >= max_frames:
                    break
                if max_seconds is not None and time_fn() - start >= max_seconds:
                    break
            for entry in pending:  # drain the pipeline
                consume(entry)
            pending.clear()
        finally:
            self._running = False
            if self.deinit_cb is not None:
                self.deinit_cb(self)
        return True
