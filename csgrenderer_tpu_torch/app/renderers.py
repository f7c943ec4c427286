"""Renderer objects: the ``Wo_Renderer`` equivalents driven by the App loop.

Twin of ``csgrenderer_tpu/app/renderers.py``. A renderer owns a scene, a
camera and a ``RenderConfig`` and exposes ``draw_frame(time_sec) -> image``
(uint8 [H, W, 3] tensor on its device), the analog of
``wo_renderer_draw_frame`` (renderer.h:20), plus ``last_frame_rays`` for
the stats clock (and, on a ``PathTraceRenderer``,
``last_frame_shadow_rays``: NEE's shadow rays, ``last_frame_tri_tests``:
a mesh frame's triangle tests, ``last_frame_masked_visits``: the voxel
visits its walk answered from the grid's occupancy mask,
``last_frame_coarse_skips``: the turns its walk skipped an empty coarse
block in, ``last_frame_leaf_tests``: a tape frame's leaf intervals, and
``last_frame_leaf_scores``: the leaf scores of its attribution through the
cluster tree, all read at the same fence).

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
cluster tuple. A renderer's config and pack are fixed for its life;
another config takes another renderer.

How frames run is decided once, when the renderer is made
(``frame_schedule``), from its device, scene type, animation, mode and
``config.debug``. On the card, without debug checks, a static sphere
scene's non-progressive frames are replayed from a CUDA graph
(``app/frame_graph.py``): the first is enqueued eagerly, the second is
captured, and later frames replay it. A static scene's progressive frames
each queue the next: a ``draw_frame`` that follows the one before it back
to back (at the sample offset that call ended at) enqueues frame k's
accumulate, denoise and tonemap, copies its counts without a wait into
pinned host memory behind an event (``_CountFence``), enqueues frame
k+1's kernel and only then waits, on that event alone; the next call
adopts the frame in flight while the sample offset still names it. A one-
shot render enqueues one kernel. Every other frame is eager. All
progressive frames run those steps in that order, eager ones without the
next kernel; all fenced frames read their counts through ``_CountFence``,
which on the CPU reads them at once. ``set_camera`` (or assigning
``camera``) rewrites the view a graph reads and, with
``reset_accumulation``, drops a queued frame.

Each frame records spans (``utils/profiling.py``) while recording is on:
``render.frame`` around ``draw_frame`` and ``draw_frame_async``, and
inside it ``render.animate``, ``render.recluster``, ``render.launch``
(with ``scene.pack`` for an animated tape; a static tape's or mesh's
pack records ``scene.pack`` when the renderer is made), ``render.fence``,
``render.accumulate``, ``render.denoise`` and ``render.tonemap``; a
replayed frame records ``render.replay`` (the replay and the copy of its
outputs) in place of the last three, and a frame that queues the next one
``render.prelaunch`` (the next frame's ``render.launch`` inside it).

A fenced frame also records its kernel's work counts while recording is
on, as counter samples (``profiling.count``) of its own frame number, at
its fence: ``kernel.segments`` on every such frame; ``kernel.leaf_scores``,
``kernel.masked_visits`` and ``kernel.coarse_skips`` where the kernel
counts them; and on a stats
frame, whose launch ran the kernel's stats instantiation (one launch in
``kernels.build.STATS_EVERY`` of those that can, chosen at the launch),
the words of its stats block (``kernel.segment_warp_steps``,
``kernel.walk_warp_steps``, ``kernel.walk_lane_steps`` and, with NEE,
``kernel.shadow_lane_steps``). A frame queued behind another carries its
own block. A replayed frame is never a stats frame: the graph replays a
launch captured without counts. On the CPU the plain versions have no
warps: every recorded frame records the lane turns of its walk as they
count them (the sphere grid's cell visits, the mesh grid's voxel visits
and coarse skips, the cluster tree's node visits) as
``kernel.walk_lane_steps``, and no warp word.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..io.checkpoint import Accumulator
from ..kernels import build, megakernel, tape_kernel, trimesh_kernel
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


def frame_schedule(device: torch.device, scene, animated: bool, progressive: bool,
                   debug: bool) -> str:
    """How a ``PathTraceRenderer``'s frames run, from what it holds when made:
    "replay" (a static sphere scene's non-progressive frames, replayed from
    a frame graph), "queue" (a static scene's progressive frames, each
    queuing the next behind it) or "eager" (every other frame, enqueued and
    fenced on its own). Only the card replays or queues, and never under
    debug checks, which read each frame back."""
    if device.type != "cuda" or animated or debug:
        return "eager"
    if progressive:
        return "queue"
    return "replay" if isinstance(scene, SphereScene) else "eager"


class _CountFence:
    """A frame's counts on their way to the host. On the card they are
    copied without a wait into pinned memory, then an event is recorded
    behind the copy, and ``wait`` blocks on that event alone, so whatever
    was enqueued after it keeps the card busy; on the CPU they are read at
    once."""

    # what a frame's counts may hold beside its segments (walk_lane_steps:
    # the plain walk's count on the CPU)
    COUNTS = ("shadow_rays", "tri_tests", "masked_visits", "coarse_skips", "leaf_tests",
              "leaf_scores", "walk_lane_steps")

    def __init__(self, device: torch.device):
        self.card = device.type == "cuda"
        self.host = torch.empty(1 + len(self.COUNTS) + len(build.STATS_WORDS), dtype=torch.int64,
                                pin_memory=self.card)
        self.event = torch.cuda.Event() if self.card else None
        self.keys = ()

    def stage(self, rays: torch.Tensor, counts: dict) -> None:
        """Copy the frame's segments, the counts of ``COUNTS`` that
        ``counts`` holds (NEE's shadow rays, a mesh's triangle tests,
        masked visits and coarse skips, a tape's leaf intervals and leaf scores, the plain
        walk's lane turns) and a stats launch's block (``"stats"``: the
        first words of ``build.STATS_WORDS``) and, on the card, mark the
        stream behind the copy."""
        self.keys = tuple(k for k in self.COUNTS if k in counts)
        src = (torch.stack((rays, *(counts[k] for k in self.keys))) if self.keys
               else rays.reshape(1))
        stats = counts.get("stats")
        if stats is not None:
            self.keys += build.STATS_WORDS[:stats.numel()]
            src = torch.cat((src, stats))
        self.host[:src.numel()].copy_(src, non_blocking=self.card)
        if self.card:
            self.event.record(torch.cuda.current_stream(src.device))

    def wait(self) -> dict[str, int]:
        """The staged counts, once the event has passed: ``"rays"`` and
        each staged key, a stats block's by its words' names."""
        if self.card:
            self.event.synchronize()
        return dict(zip(("rays",) + self.keys, self.host[:1 + len(self.keys)].tolist()))


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
        self._camera = camera.to(self.device)
        self._config = config
        self.progressive = progressive
        self.advance_samples = advance_samples
        self.accumulator = Accumulator.zeros(config.height, config.width, self.device)
        self.last_frame_rays = 0
        # NEE's shadow rays of the last fenced frame: 0 without NEE, None
        # where its kernel counts none (tape, mesh, a replayed frame)
        self.last_frame_shadow_rays = 0
        # the triangle tests of the last fenced frame's path segments, their
        # voxel visits the grid's occupancy mask answered and their walks'
        # coarse skips: None where it has no such count (a sphere or tape
        # frame)
        self.last_frame_tri_tests = None
        self.last_frame_masked_visits = None
        self.last_frame_coarse_skips = None
        # the leaf intervals of the last fenced frame's path segments, and
        # the leaf scores of its attribution through the cluster tree: None
        # where it has no such count (a sphere or mesh frame; no scores
        # without the tree)
        self.last_frame_leaf_tests = None
        self.last_frame_leaf_scores = None
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
        self._schedule = frame_schedule(self.device, self.scene, animate is not None,
                                        progressive, config.debug)
        self._fence = _CountFence(self.device)
        self._graph = None  # the FrameGraph that "replay" frames replay
        self._warm = False  # whether an eager frame has run (and bound the kernels)
        # the progressive frame queued behind the last one, (radiance, rays,
        # counts), and the sample offset that draw ended at, which that
        # frame was rendered at; both dropped when the state moves
        self._ahead = None
        self._ended = None

    @property
    def config(self) -> RenderConfig:
        """The render config, fixed for the renderer's life: the pack, a
        frame graph and a queued frame are made for it."""
        return self._config

    @config.setter
    def config(self, _):
        raise AttributeError("a PathTraceRenderer's config is fixed for its life: make a new "
                             "renderer for another config, as AdaptiveSppRenderer's rungs do")

    def set_camera(self, camera) -> None:
        """Swap the view for subsequent frames (``r.camera = ...`` does the
        same). Progressive accumulations of the old view are the caller's
        to reset; a progressive frame queued for the old view is dropped. A
        captured frame graph reads the view from device memory, where the
        new one is written."""
        self._camera = camera.to(self.device)
        if self._graph is not None:
            self._graph.set_camera(self._camera)
        self._ahead = self._ended = None

    camera = property(lambda self: self._camera, set_camera)

    def reset_accumulation(self) -> None:
        self.accumulator = Accumulator.zeros(self.config.height, self.config.width, self.device)
        self._sample_offset = 0
        self._ahead = self._ended = None  # a frame in flight is dropped

    def _render(self, time_sec: float, partition=None, counts: dict | None = None):
        """One frame's (radiance [H, W, 3], rays int64 tensor) at the
        current sample offset. The frame's NEE shadow rays, triangle tests
        and leaf intervals, where its kernel counts them, are added to
        ``counts`` (``_render_kernel``)."""
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
                                            partition=partition, counts=counts)
        if self.config.debug:
            check_finite(radiance, "the frame's radiance")
        return radiance, rays

    def _tonemap(self, linear: torch.Tensor) -> torch.Tensor:
        with profiling.span("render.tonemap"):
            return to_uint8(tonemap(linear, gamma=self.config.gamma))

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
        """Enqueue a non-progressive frame and advance the sample offset as
        configured: (uint8 image, rays int64 tensor), both still being
        computed. Under "replay" the first frame is enqueued eagerly, which
        binds every kernel library and sets every kernel attribute; the
        second is captured into the frame graph, and every later one
        replays it. An eager frame adds its counts to ``counts`` (``_render``)."""
        cfg = self.config
        if self._graph is None and self._warm and self._schedule == "replay":
            self._graph = frame_graph.FrameGraph(self._captured_frame, self.device, cfg.spp,
                                                 (cfg.height, cfg.width), self.camera)
        if self._graph is not None:
            with profiling.span("render.replay"):
                image, rays = self._graph.replay(self._sample_offset)
        else:
            radiance, rays = self._render(time_sec, counts=counts)
            image = self._tonemap(self.denoise_image(radiance, time_sec))
            self._warm = True
        if self.advance_samples:
            self._sample_offset += cfg.spp
        return image, rays

    def _recluster(self, time_sec: float) -> tuple:
        """Clusters of the animated tape at ``time_sec``, computed on the
        CPU copy. Returns ``partition_tape``'s tuple, or () when nothing
        splits (the global evaluation)."""
        with profiling.span("render.recluster"):
            clusters = partition_tape(self._animate(self._cpu_twin, time_sec))
        return clusters if clusters is not None else ()

    def _read_fence(self) -> None:
        """The frame's one wait, on its staged counts: its segments into
        ``last_frame_rays``, its shadow rays into
        ``last_frame_shadow_rays`` (0 without NEE, None where the kernel
        counts none), its triangle tests into ``last_frame_tri_tests``, its
        masked visits into ``last_frame_masked_visits``, its coarse skips
        into ``last_frame_coarse_skips``, its leaf
        intervals into ``last_frame_leaf_tests`` and its leaf scores into
        ``last_frame_leaf_scores`` (None where the kernel counts none).
        While recording is on, the counts named in ``RECORDED`` are
        recorded as counter samples of this frame (module docstring)."""
        with profiling.span("render.fence"):
            got = self._fence.wait()
            self.last_frame_rays = got["rays"]
            self.last_frame_shadow_rays = got.get("shadow_rays",
                                                  None if self.config.nee else 0)
            self.last_frame_tri_tests = got.get("tri_tests")
            self.last_frame_masked_visits = got.get("masked_visits")
            self.last_frame_coarse_skips = got.get("coarse_skips")
            self.last_frame_leaf_tests = got.get("leaf_tests")
            self.last_frame_leaf_scores = got.get("leaf_scores")
            if profiling.RECORDER.on:
                profiling.count("kernel.segments", got["rays"])
                for key in RECORDED:
                    if key in got:
                        profiling.count("kernel." + key, got[key])

    def draw_frame(self, time_sec: float) -> torch.Tensor:
        with profiling.frame("render.frame"):
            if self.progressive:
                return self._draw_progressive(time_sec)
            counts = {}
            image, rays = self._enqueue(time_sec, counts)
            self._fence.stage(rays, counts)
            self._read_fence()
            return image

    def _draw_progressive(self, time_sec: float) -> torch.Tensor:
        """A progressive frame k, in this order on the stream: its kernel
        (adopted from the call before when that call queued it at this
        sample offset, else enqueued now); its accumulate, denoise and
        tonemap; its counts, staged in the fence; under "queue", frame
        k+1's kernel at offset (k+1) spp, when this call follows the one
        before back to back (so a one-shot render enqueues one kernel).
        Then the one wait, on frame k's counts, which the accumulator's ray
        count takes. Returns frame k's image."""
        cfg = self.config
        follows = self._ended == self._sample_offset
        ahead = self._ahead if follows else None
        self._ahead = None
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
        self._fence.stage(rays, counts)
        if follows and self._schedule == "queue":
            with profiling.span("render.prelaunch"):
                queued = {}
                self._ahead = (*self._render(time_sec, counts=queued), queued)
        self._ended = self._sample_offset
        self._read_fence()
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
    frame's shadow rays (``megakernel.render_image_kernel``), a tape frame's
    leaf intervals and leaf scores (``tape_kernel.render_image_tape_kernel``)
    and a mesh frame's triangle tests, masked visits and coarse skips
    (``trimesh_kernel.render_image_mesh_kernel``) are added, and a stats
    launch's block (``"stats"``) or, on the CPU, the lane turns of the
    plain walk (``"walk_lane_steps"``: the sphere grid's cell visits, the
    mesh grid's voxel visits and coarse skips, the cluster tree's node
    visits).
    """
    kw = dict(spp=cfg.spp, max_bounces=cfg.max_bounces, seed=cfg.seed, sky=cfg.sky, lens=cfg.lens,
              sample_offset=sample_base, nee=cfg.nee, jitter=cfg.jitter)
    if isinstance(scene, (SphereScene, megakernel.PackedScene)):
        render = functools.partial(megakernel.render_image_kernel, offset_buffer=offset_buffer)
        keys, walk = ("shadow_rays",), ("cell_visits",)
    elif isinstance(scene, (CompiledTape, tape_kernel.PackedTape)):
        if isinstance(scene, CompiledTape):
            kw["partition"] = partition if partition is not None else (
                False if animated else "auto")
        render = tape_kernel.render_image_tape_kernel
        keys, walk = ("leaf_tests", "leaf_scores"), ("node_visits",)
    elif isinstance(scene, (MeshScene, trimesh_kernel.PackedMesh)):
        render = trimesh_kernel.render_image_mesh_kernel
        keys = ("tri_tests", "masked_visits", "coarse_skips")
        walk = ("voxel_visits", "coarse_skips")
    else:
        raise TypeError(f"unsupported scene type {type(scene).__name__}")
    # the kernel's own counts alone: the plain versions count the walk's
    # work and NEE's too, which the kernels do not, and a frame reads alike
    # on both
    own = None if counts is None else {}
    out = render(scene, camera, cfg.width, cfg.height, counts=own, **kw)
    if counts is not None:
        counts.update((key, own[key]) for key in keys + ("stats",) if key in own)
        if walk[0] in own:
            counts["walk_lane_steps"] = torch.as_tensor(sum(own.get(k, 0) for k in walk),
                                                        dtype=torch.int64, device=out[1].device)
    return out


# the counts a fenced frame records as counter samples ("kernel." + key),
# where it has them, beside its segments
RECORDED = ("leaf_scores", "masked_visits", "coarse_skips") + build.STATS_WORDS
