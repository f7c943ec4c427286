"""Renderer objects: the ``Wo_Renderer`` equivalents driven by the App loop.

Twin of ``csgrenderer_tpu/app/renderers.py``. A renderer owns a scene, a
camera and a ``RenderConfig`` and exposes ``draw_frame(time_sec) -> image``
(uint8 [H, W, 3] tensor on its device), the analog of
``wo_renderer_draw_frame`` (renderer.h:20), plus ``last_frame_rays`` for
the stats clock (and, on a ``PathTraceRenderer``,
``last_frame_shadow_rays``: NEE's shadow rays, read at the same fence).

- ``WololoRenderer``: the milestone-01 animated frame (config 1), plain
  torch ops on the renderer's device.
- ``PathTraceRenderer``: a ``SphereScene``, ``CompiledTape`` or
  ``MeshScene`` through the port's kernels, with an optional per-frame
  animation, progressive accumulation, render-to-noise (configs 2-5,
  7 and the mesh milestone) and the a-trous denoise step
  (``RenderConfig(denoise=True)``: on the card a sphere scene's AOVs
  through the sphere kernel's G-buffer mode, over the beauty frame's
  packed tables, and a tape's or mesh's through its plain hit function,
  as on the CPU; the filter through its kernel).

``device`` (default "cuda") decides what runs, as the kernel wrappers do:
on "cuda" every frame launches the CUDA kernel of its scene type, and a
host without CUDA raises; on "cpu" the kernels' plain torch versions run.
Nothing falls back from one to the other. The JAX package's
``backend=``/``interpret=`` become this one argument.

Static scenes are packed once, when the renderer is made; per frame only
the camera row is built and the kernel launched, so ``draw_frame_async``
never waits for the device. Animated CSG tapes are reclustered every frame
on a CPU copy of the tape (``scene/partition.py``) and packed with that
cluster tuple.

On the card, a non-progressive frame of a static sphere scene is replayed
from a CUDA graph (``app/frame_graph.py``): the first such frame of a
config is enqueued eagerly, the next is captured, and later frames replay
it until a new config object or a new pack drops it; ``set_camera``
rewrites the view the graph reads.

On the card, a progressive frame of a static scene keeps the next frame
queued behind it (``prelaunch_eligible``): a ``draw_frame`` that follows
the frame before it back to back (the same sample offset, config object,
pack and camera) enqueues frame k's accumulate and tonemap, copies its
counts without a wait into pinned host memory behind an event
(``_CountFence``), enqueues frame k+1's kernel and only then waits, on
that event alone. The next call adopts the frame in flight, or drops it
when the renderer's state moved, so the card always has a kernel queued
while the host finishes a frame. A one-shot render enqueues one kernel.

Each frame records spans (``utils/profiling.py``) while recording is on:
``render.frame`` around ``draw_frame`` and ``draw_frame_async``, and
inside it ``render.animate``, ``render.recluster``, ``render.launch``
(with ``scene.pack`` for an animated tape), ``render.fence``,
``render.accumulate``, ``render.denoise`` and ``render.tonemap``; a
replayed frame records ``render.replay`` (the replay and the copy of its
outputs) in place of the last three, and a frame that queues the next one
``render.prelaunch`` (the next frame's ``render.launch`` inside it).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..io.checkpoint import Accumulator
from ..kernels import megakernel, tape_kernel, trimesh_kernel
from ..render import integrator
from ..render.aov import render_aovs
from ..render.denoise import atrous_denoise
from ..render.integrator import SphereScene
from ..render.lights import extract_tape_lights
from ..render.tonemap import to_uint8, tonemap
from ..render.trimesh import MeshScene
from ..scene.partition import partition_tape
from ..scene.tape import CompiledTape
from ..utils import profiling
from ..utils.config import RenderConfig, check_finite
from . import frame_graph


def resolve_device(device) -> torch.device:
    """The renderer's device: "cuda" (the kernels) or "cpu" (their plain
    versions); raises where CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available "
                           "(device='cpu' runs the kernels' plain versions)")
    return dev


def prelaunch_eligible(renderer) -> bool:
    """Whether ``renderer``'s progressive frames may keep the next frame
    queued behind the current one: a static scene (packed once) on the
    card, without debug checks, which read each frame back. Every other
    frame is rendered and fenced on its own."""
    return (renderer.device.type == "cuda" and renderer.progressive
            and renderer._packed is not None and not renderer.config.debug)


def _same_key(a: tuple, b: tuple) -> bool:
    """Whether two frame keys (sample offset, config, pack, camera) name
    the same frame: an equal offset and the same three objects."""
    return a[0] == b[0] and all(x is y for x, y in zip(a[1:], b[1:]))


class _CountFence:
    """A frame's counts on their way to the host: copied without a wait
    into pinned memory, then an event recorded behind the copy. ``wait``
    blocks on that event alone, so whatever was enqueued after it keeps
    the card busy."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        self.event = torch.cuda.Event()
        self.n = 0

    def stage(self, rays: torch.Tensor, shadow: torch.Tensor | None) -> None:
        """Copy the frame's segments (and NEE's shadow rays) and mark the
        stream behind the copy."""
        src = rays.reshape(1) if shadow is None else torch.stack((rays, shadow))
        self.n = src.numel()
        self.host[:self.n].copy_(src, non_blocking=True)
        self.event.record(torch.cuda.current_stream(self.device))

    def wait(self) -> list[int]:
        """The staged counts, once the event has passed."""
        self.event.synchronize()
        return self.host[:self.n].tolist()


class WololoRenderer:
    """Draws the reference's hard-coded animated-sphere frame (config 1).

    ``entry_point``: "rt1_1" (the ray tracer, frag:147-152, default) or
    "debug_view_1" (the st-coordinate visualizer, frag:132-137); the
    reference switches these by editing main() and recompiling the shader.
    """

    def __init__(self, config: RenderConfig, entry_point: str = "rt1_1", device="cuda"):
        if entry_point not in ("rt1_1", "debug_view_1"):
            raise ValueError(f"unknown entry point {entry_point!r}")
        self.config = config
        self.device = resolve_device(device)
        self.entry_point = entry_point
        self.last_frame_rays = config.width * config.height  # 1 primary/px

    def _radiance(self, time_sec: float) -> torch.Tensor:
        cfg = self.config
        if self.entry_point == "rt1_1":
            lin = integrator.render_wololo_frame(time_sec, cfg.width, cfg.height, self.device)
        else:
            lin = integrator.render_debug_view_1(cfg.width, cfg.height, self.device)
        if cfg.debug:
            check_finite(lin, "the frame's radiance")
        # the reference writes linear color (gamma 1)
        return to_uint8(tonemap(lin, gamma=1.0))

    def draw_frame(self, time_sec: float) -> torch.Tensor:
        return self._radiance(time_sec)

    def draw_frame_async(self, time_sec: float):
        """(image, rays); the image is still being computed on the device."""
        return self._radiance(time_sec), self.last_frame_rays


class PathTraceRenderer:
    """Path-traces a scene each frame; optionally accumulates progressively.

    ``animate``: optional ``(scene, time_sec) -> scene`` applied per frame
    (e.g. ``CompiledTape.with_edges`` for config 5). ``progressive``:
    accumulate samples across frames instead of restarting (each frame adds
    ``config.spp`` samples); ``reset_accumulation()`` clears.
    ``advance_samples``: advance the RNG sample offset by ``spp`` each frame
    without accumulating, so every frame is an independent fresh-noise
    render (the realtime mode, safe with frames in flight, unlike
    ``progressive``). ``device``: see the module docstring.
    """

    def __init__(
        self,
        scene,
        camera,
        config: RenderConfig,
        animate: Optional[Callable] = None,
        progressive: bool = False,
        sample_offset: int = 0,
        device="cuda",
        advance_samples: bool = False,
    ):
        if not isinstance(scene, (SphereScene, CompiledTape, MeshScene)):
            raise TypeError(f"unsupported scene type {type(scene).__name__}")
        if progressive and advance_samples:
            raise ValueError("progressive already advances sample offsets")
        self.device = resolve_device(device)
        if not config.jitter and self.device.type == "cuda":
            raise NotImplementedError(
                "RenderConfig(jitter=False) is refused on device='cuda': the CUDA kernels always "
                "jitter, as the JAX package's kernels do; device='cpu' renders pixel centres "
                "through the plain versions")
        self.scene = scene.to(self.device)
        self.camera = camera.to(self.device)
        self.config = config
        self.progressive = progressive
        self.advance_samples = advance_samples
        self.accumulator = Accumulator.zeros(config.height, config.width, self.device)
        self.last_frame_rays = 0
        # NEE's shadow rays of the last fenced frame: 0 without NEE, None
        # where its kernel counts none (tape, mesh, a replayed frame)
        self.last_frame_shadow_rays = 0
        self._sample_offset = sample_offset
        self._animate = animate

        if config.nee and animate is not None and self.device.type == "cpu":
            # as the JAX package's jnp backend: the plain path samples the
            # lamps it was given, which animation could move
            raise NotImplementedError(
                "nee + animate on the CPU would sample the constructor-time lamp "
                "positions; use device='cuda' (the kernel reads each frame's leaf table)")
        # static scenes are packed once (lamp tables included); animated
        # ones every frame
        self._packed = None if animate is not None else _pack(self.scene)
        self._frame_pack = None  # (time, PackedScene) of an animated sphere scene's last frame
        if config.nee and not _has_lamps(self.scene, self._packed):
            raise ValueError("RenderConfig.nee but the scene has no emissive lamps")
        # animated tapes recluster per frame on a CPU copy, so no readback
        # from the card is needed to choose the clusters
        self._cpu_twin = (self.scene.to("cpu")
                          if isinstance(scene, CompiledTape) and animate is not None else None)
        self._graph = None  # the FrameGraph replayed by eligible frames
        self._warmed = None  # (config, pack) of the last eager eligible frame
        # a progressive frame queued behind the last one (``_draw_queued``):
        # the key a frame drawn next, back to back, has; that frame's
        # (radiance, rays, counts) when already enqueued; the counts' fence
        self._next = None
        self._ahead = None
        self._fence = None

    def _render(self, time_sec: float, partition=None, counts: dict | None = None):
        """One frame's (radiance [H, W, 3], rays int64 tensor) at the
        current sample offset. With NEE, the frame's shadow rays are added
        to ``counts`` (``_render_kernel``)."""
        if self._animate is None:
            scene = self._packed
        else:
            with profiling.span("render.animate"):
                scene = self._animate(self.scene, time_sec)
                if isinstance(scene, SphereScene):  # packed once: the denoise step casts over it
                    scene = megakernel.pack_scene(scene)
                    self._frame_pack = (time_sec, scene)
            if self._cpu_twin is not None and partition is None:
                partition = self._recluster(time_sec)
        with profiling.span("render.launch"):
            radiance, rays = _render_kernel(scene, self.camera, self.config, self._sample_offset,
                                            animated=self._animate is not None,
                                            partition=partition,
                                            counts=counts if self.config.nee else None)
        if self.config.debug:
            check_finite(radiance, "the frame's radiance")
        return radiance, rays

    def _tonemap(self, linear: torch.Tensor) -> torch.Tensor:
        with profiling.span("render.tonemap"):
            return to_uint8(tonemap(linear, gamma=self.config.gamma))

    def reset_accumulation(self) -> None:
        self.accumulator = Accumulator.zeros(self.config.height, self.config.width, self.device)
        self._sample_offset = 0
        self._next = self._ahead = None  # a frame in flight is dropped

    def set_camera(self, camera) -> None:
        """Swap the view for subsequent frames. Progressive accumulations of
        the old view are the caller's to reset; a progressive frame queued
        for the old view is dropped at the next ``draw_frame`` (its key
        names the camera object). A captured frame graph reads the view
        from device memory, where the new one is written."""
        self.camera = camera.to(self.device)
        if self._graph is not None:
            self._graph.set_camera(self.camera)

    def _frame_graph(self):
        """The frame graph this frame replays, captured now if it is due;
        None for an eagerly enqueued frame. A graph whose config or pack the
        renderer no longer holds is dropped. An eligible frame
        (``frame_graph.eligible``) is captured once an eager frame of the
        same config and pack has run, which bound every kernel library and
        set every kernel attribute."""
        g = self._graph
        if g is not None and not g.holds(self.config, self._packed):
            g = self._graph = None
        if g is not None or not frame_graph.eligible(self):
            return g
        key = (self.config, self._packed)
        if self._warmed is None or any(a is not b for a, b in zip(self._warmed, key)):
            self._warmed = key
            return None
        self._graph = frame_graph.FrameGraph(self._captured_frame, self.device, *key,
                                             self.camera)
        return self._graph

    def _captured_frame(self, offset, camera, image):
        """The frame a graph captures: beauty, denoise and tonemap into
        ``image``; the kernels read the sample offset from ``offset`` and
        the view from the packed row ``camera``. Returns the rays."""
        cfg = self.config
        radiance, rays = _render_kernel(self._packed, camera, cfg, 0, offset_buffer=offset)
        linear = self._denoise(radiance, 0.0, camera) if cfg.denoise else radiance
        to_uint8(tonemap(linear, gamma=cfg.gamma), out=image)
        return rays

    def _enqueue(self, time_sec: float, counts: dict | None = None):
        """Enqueue a non-progressive frame, replayed from the frame graph
        when there is one, and advance the sample offset as configured:
        (uint8 image, rays int64 tensor), both still being computed. An
        eager NEE frame adds its shadow rays to ``counts``."""
        graph = self._frame_graph()
        if graph is not None:
            with profiling.span("render.replay"):
                image, rays = graph.replay(self._sample_offset)
        else:
            radiance, rays = self._render(time_sec, counts=counts)
            image = self._tonemap(self.denoise_image(radiance, time_sec))
        if self.advance_samples:
            self._sample_offset += self.config.spp
        return image, rays

    def _recluster(self, time_sec: float) -> tuple:
        """Clusters of the animated tape at ``time_sec``, computed on the
        CPU copy. Returns ``partition_tape``'s tuple, or () when nothing
        splits (the global evaluation)."""
        with profiling.span("render.recluster"):
            clusters = partition_tape(self._animate(self._cpu_twin, time_sec))
        return clusters if clusters is not None else ()

    def _read_counts(self, rays, counts: dict) -> None:
        """The fence: the frame's segments into ``last_frame_rays`` and its
        shadow rays into ``last_frame_shadow_rays``, both read from the
        device in one transfer."""
        shadow = counts.get("shadow_rays")
        self._set_counts(*([int(rays)] if shadow is None else torch.stack((rays, shadow)).tolist()))

    def _set_counts(self, rays: int, shadow: int | None = None) -> None:
        """A fenced frame's counts: NEE's shadow rays 0 without NEE, None
        where the kernel counts none."""
        self.last_frame_rays = rays
        self.last_frame_shadow_rays = (shadow if shadow is not None
                                       else None if self.config.nee else 0)

    def _frame_key(self) -> tuple:
        return (self._sample_offset, self.config, self._packed, self.camera)

    def draw_frame(self, time_sec: float) -> torch.Tensor:
        counts = {}
        with profiling.frame("render.frame"):
            if not self.progressive:
                image, rays = self._enqueue(time_sec, counts)
                with profiling.span("render.fence"):
                    self._read_counts(rays, counts)
                return image
            if prelaunch_eligible(self):
                return self._draw_queued(time_sec)
            radiance, rays = self._render(time_sec, counts=counts)
            with profiling.span("render.fence"):
                self._read_counts(rays, counts)
            with profiling.span("render.accumulate"):
                self.accumulator = self.accumulator.add(radiance * self.config.spp,
                                                        self.config.spp, self.last_frame_rays)
                self._sample_offset += self.config.spp
                linear = self.accumulator.image()
            return self._tonemap(self.denoise_image(linear, time_sec))

    def _draw_queued(self, time_sec: float) -> torch.Tensor:
        """A progressive frame k with frame k+1 queued behind it, in this
        order on the stream: frame k's kernel (adopted from the call before
        when its key is this frame's, else enqueued now); its accumulate,
        denoise and tonemap, the same ops as ``draw_frame``'s; its counts,
        staged in ``_CountFence``; frame k+1's kernel at offset (k+1) spp,
        when the call before drew frame k-1 under the same key. Then the one
        wait, on frame k's event. Returns frame k's image."""
        cfg = self.config
        follows = self._next is not None and _same_key(self._next, self._frame_key())
        ahead = self._ahead if follows else None
        self._next = self._ahead = None  # a frame in flight that does not match is dropped
        if ahead is not None:
            radiance, rays, counts = ahead
        else:
            counts = {}
            radiance, rays = self._render(time_sec, counts=counts)
        with profiling.span("render.accumulate"):
            summed = self.accumulator.add(radiance * cfg.spp, cfg.spp, 0)  # rays at the fence
            self._sample_offset += cfg.spp
            linear = summed.image()
        image = self._tonemap(self.denoise_image(linear, time_sec))
        if self._fence is None:
            self._fence = _CountFence(self.device)
        self._fence.stage(rays, counts.get("shadow_rays"))
        if follows:
            with profiling.span("render.prelaunch"):
                queued = {}
                self._ahead = (*self._render(time_sec, counts=queued), queued)
        self._next = self._frame_key()
        with profiling.span("render.fence"):
            self._set_counts(*self._fence.wait())
        self.accumulator = summed._replace(rays_traced=summed.rays_traced + self.last_frame_rays)
        return image

    def draw_frame_async(self, time_sec: float):
        """Launch a frame without waiting for the device.

        Returns (uint8 image, ray-count int64 tensor), both still being
        computed: the caller consumes them later (the App's frames in
        flight). Progressive accumulation keeps host state per frame, so
        it stays on the synchronous path.
        """
        if self.progressive:
            raise ValueError("progressive accumulation is synchronous")
        with profiling.frame("render.frame"):
            return self._enqueue(time_sec)

    def denoise_image(self, linear: torch.Tensor, time_sec: float = 0.0) -> torch.Tensor:
        """The configured denoise of a linear radiance image: with
        ``config.denoise``, the AOVs of the frame's geometry (the scene
        animated to ``time_sec``), then ``config.denoise_iterations`` passes
        of the a-trous filter (its CUDA kernel on the card); else the image
        as it is. A sphere scene on the card casts its AOVs through the
        sphere kernel's G-buffer mode over the tables its beauty frame read
        (packed once: when static, or by that frame's ``_render``); every
        other scene type, and every scene on the CPU, through its plain hit
        function. Nothing here waits for the device."""
        cfg = self.config
        if not cfg.denoise:
            return linear
        with profiling.span("render.denoise"):
            return self._denoise(linear, time_sec, self.camera)

    def _denoise(self, linear: torch.Tensor, time_sec: float, camera) -> torch.Tensor:
        """``denoise_image``'s work, the sphere kernel's cast taking the view
        ``camera`` (or its packed row)."""
        cfg = self.config
        if isinstance(self.scene, SphereScene) and self.device.type == "cuda":
            aovs = megakernel.render_aovs_kernel(self._sphere_pack(time_sec), camera,
                                                 cfg.width, cfg.height, sky=cfg.sky)
            return atrous_denoise(linear, aovs, iterations=cfg.denoise_iterations)
        scene = self.scene if self._animate is None else self._animate(self.scene, time_sec)
        face_chunk = row_chunk = None
        if isinstance(scene, MeshScene) and scene.num_faces > 8192:
            # bound the brute cast's [rays x faces] planes to 2^26 entries
            face_chunk = 2048
            row_chunk = max(1, (1 << 26) // (cfg.width * face_chunk))
        aovs = render_aovs(hit_fn_for(scene, face_chunk=face_chunk), camera, cfg.width,
                           cfg.height, sky=cfg.sky, row_chunk=row_chunk)
        return atrous_denoise(linear, aovs, iterations=cfg.denoise_iterations)

    def _sphere_pack(self, time_sec: float):
        """The packed sphere scene of the frame at ``time_sec``: the static
        pack, or the animated frame's from ``_render`` (packed here only for
        a time no frame was rendered at)."""
        if self._packed is not None:
            return self._packed
        if self._frame_pack is not None and self._frame_pack[0] == time_sec:
            return self._frame_pack[1]
        return megakernel.pack_scene(self._animate(self.scene, time_sec))

    def render_to_noise(self, target: float = 1e-3, max_spp: int = 1 << 16,
                        time_sec: float = 0.0):
        """Render until the measured Monte-Carlo noise reaches ``target``.

        Accumulates ``cfg.spp``-sized frames into two independent
        half-streams (disjoint sample offsets, exact under the
        counter-based RNG) and estimates the noise of the combined image as
        rmse(tonemap(A), tonemap(B)) / 2 on gamma-2 floats, at power-of-two
        counts of frame pairs. Returns ``(accumulator, noise, spp_used)``;
        the renderer's sample offset advances past the consumed range, so
        later ``draw_frame`` calls compose exactly.
        """
        cfg = self.config
        acc = [Accumulator.zeros(cfg.height, cfg.width, self.device) for _ in range(2)]
        partition = self._recluster(time_sec) if self._cpu_twin is not None else None
        noise = float("inf")
        pairs = 0
        next_check = 1
        while 2 * pairs * cfg.spp < max_spp:
            for which in range(2):
                radiance, rays = self._render(time_sec, partition)
                acc[which] = acc[which].add(radiance * cfg.spp, cfg.spp, rays)
                self._sample_offset += cfg.spp
            pairs += 1
            if pairs >= next_check:
                next_check *= 2
                a, b = (tonemap(x.image(), gamma=2.0).cpu().numpy().astype(np.float64)
                        for x in acc)
                noise = float(np.sqrt(np.mean((a - b) ** 2))) / 2.0
                if noise <= target:
                    break
        merged = Accumulator(
            radiance_sum=acc[0].radiance_sum + acc[1].radiance_sum,
            sample_count=acc[0].sample_count + acc[1].sample_count,
            rays_traced=acc[0].rays_traced + acc[1].rays_traced,
        )
        if self.progressive:
            self.accumulator = Accumulator(
                radiance_sum=self.accumulator.radiance_sum + merged.radiance_sum,
                sample_count=self.accumulator.sample_count + merged.sample_count,
                rays_traced=self.accumulator.rays_traced + merged.rays_traced,
            )
        return merged, noise, 2 * pairs * cfg.spp


def hit_fn_for(scene, eps: float = 1e-3, face_chunk: int | None = None):
    """The plain hit function ``(o, d) -> SurfaceHit`` of an unpacked scene."""
    if isinstance(scene, SphereScene):
        return functools.partial(SphereScene.nearest_hit, scene, eps=eps)
    if isinstance(scene, CompiledTape):
        return functools.partial(integrator.tape_hit_adapter, scene, eps=eps)
    if isinstance(scene, MeshScene):
        return functools.partial(MeshScene.nearest_hit, scene, eps=eps, face_chunk=face_chunk)
    raise TypeError(f"unsupported scene type {type(scene).__name__}")


def _pack(scene):
    if isinstance(scene, SphereScene):
        return megakernel.pack_scene(scene)
    if isinstance(scene, CompiledTape):
        return tape_kernel.pack_program(scene)
    return trimesh_kernel.pack_mesh(scene)


def _has_lamps(scene, packed) -> bool:
    if isinstance(scene, CompiledTape):
        return extract_tape_lights(scene) is not None
    return (packed if packed is not None else _pack(scene)).lamps is not None


def _render_kernel(scene, camera, cfg: RenderConfig, sample_base: int, animated: bool = False,
                   partition=None, offset_buffer=None, counts=None):
    """One frame through the kernel wrapper of the scene's type (the twin of
    the JAX package's ``_render_pallas``): (radiance, rays int64 tensor).

    ``scene`` may be packed. ``partition`` is an animated tape's cluster
    tuple; an animated tape without one takes the global evaluation rather
    than clustering on device tensors. ``counts``: a dict to which a sphere
    frame's NEE work is added (``megakernel.render_image_kernel``); the
    tape and mesh wrappers count none.
    """
    kw = dict(spp=cfg.spp, max_bounces=cfg.max_bounces, seed=cfg.seed, sky=cfg.sky, lens=cfg.lens,
              sample_offset=sample_base, nee=cfg.nee, jitter=cfg.jitter)
    if isinstance(scene, (SphereScene, megakernel.PackedScene)):
        return megakernel.render_image_kernel(scene, camera, cfg.width, cfg.height,
                                              offset_buffer=offset_buffer, counts=counts, **kw)
    if isinstance(scene, (CompiledTape, tape_kernel.PackedTape)):
        if isinstance(scene, CompiledTape):
            kw["partition"] = partition if partition is not None else (
                False if animated else "auto")
        return tape_kernel.render_image_tape_kernel(scene, camera, cfg.width, cfg.height, **kw)
    if isinstance(scene, (MeshScene, trimesh_kernel.PackedMesh)):
        return trimesh_kernel.render_image_mesh_kernel(scene, camera, cfg.width, cfg.height, **kw)
    raise TypeError(f"unsupported scene type {type(scene).__name__}")
