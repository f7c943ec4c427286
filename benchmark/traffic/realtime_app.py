"""The live denoised frame: ``App.run`` over ``PathTraceRenderer`` with
fresh noise every frame, frames in flight, each frame handed to a sink
that timestamps it.

The mix file gives the frame (``width``, ``height``, ``spp``), the
a-trous passes (``denoise_passes``), the frames in flight and
``App.run``'s readback mode and fence stride: with "fence" and stride 1
the sink gets each frame as a device tensor and the loop reads every
frame's ray count back, so each frame's completion is waited for. The
renderer advances its sample offset by spp each frame
(``advance_samples``), so window frame i renders samples
[(warm + i) spp, (warm + i + 1) spp) after ``warm_frames`` warm-up frames
through the same ``App.run``. The loop is closed: a frame is dispatched
when the oldest in flight has been delivered.

Each dispatch goes through a wrapper that times the host's
``draw_frame_async`` (``Run.enqueue_s``) and, traced, marks it with a span;
the sink's own work is a span too.

The check renders frame 0, ``RESERVOIR`` frames drawn from the seed
among the rest and the last frame with the plain reference (the beauty
frame, the G-buffer, the a-trous filter, the tonemap) and compares:

- ``image_share``: the share of the delivered pixels (copied to the host
  after the window) off the reference's by more than one level;
- ``order_gap``: delivered frames whose index is not the next one (exact).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import compare
from benchmark.harness import camera
from benchmark.reference import core, denoise

SPANS = ("app.run", "draw_frame_async", "sink")
RESERVOIR_SALT = 0x5EED0003
RESERVOIR = 2  # delivered frames drawn from the seed among the second to last
MAX_RAYS = 1 << 21
SIGMAS = dict(sigma_color=2.0, sigma_normal=32, sigma_depth=0.15, color_sigma_decay=2.0)


class TimedRenderer:
    """Forwards to the renderer, timing ``draw_frame_async`` on the host."""

    def __init__(self, inner, tracer, enqueue_s: list):
        self.inner, self.tracer, self.enqueue_s = inner, tracer, enqueue_s

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def draw_frame_async(self, t):
        with self.tracer.span("draw_frame_async"):
            t0 = time.perf_counter()
            out = self.inner.draw_frame_async(t)
            self.enqueue_s.append(time.perf_counter() - t0)
        return out


def setup(run) -> None:
    from csgrenderer_tpu_torch.app import App, PathTraceRenderer
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    mix, cfg = run.mix, run.config
    scene, animate = run.config_module.program_scene(cfg, run.device, False, cfg["time"])
    cam_args = camera(cfg, run.cell)
    cam = Camera.look_at(aspect_ratio=mix["width"] / mix["height"], device=run.device, **cam_args)
    rc = RenderConfig(width=mix["width"], height=mix["height"], spp=mix["spp"],
                      max_bounces=cfg["bounces"], seed=run.render_seed, sky=cfg["sky"],
                      gamma=cfg["gamma"], lens=cam_args["aperture"] > 0.0, denoise=True,
                      denoise_iterations=mix["denoise_passes"])
    renderer = PathTraceRenderer(scene, cam, rc, animate=animate, advance_samples=True,
                                 device=run.device)
    app = App(target_updates_per_sec=60.0, width=mix["width"], height=mix["height"])
    app.swap_scene(renderer)
    app.run(max_frames=mix["warm_frames"], frames_in_flight=mix["frames_in_flight"],
            readback=mix["readback"], fence_stride=mix["fence_stride"])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.state = (app, renderer)


def window(run, tracer) -> None:
    app, renderer = run.state
    rng = random.Random(run.seed ^ RESERVOIR_SALT)
    size = RESERVOIR
    kept = {"first": None, "reservoir": [], "last": None, "order": 0}

    def sink(idx, image):
        with tracer.span("sink"):
            run.frames.append((time.perf_counter(), None))
            k = len(run.frames) - 1
            kept["order"] += int(idx != k)
            if k == 0:
                kept["first"] = (idx, image)
            elif len(kept["reservoir"]) < size:
                kept["reservoir"].append((idx, image))
            else:
                j = rng.randrange(k)  # k - 1 candidates before this one, this one included
                if j < size:
                    kept["reservoir"][j] = (idx, image)
            kept["last"] = (idx, image)

    app.frame_sink = sink
    app.swap_scene(TimedRenderer(renderer, tracer, run.enqueue_s))
    run.t0 = time.perf_counter()
    with tracer.span("app.run"):
        app.run(max_seconds=run.loop_seconds, frames_in_flight=run.mix["frames_in_flight"],
                readback=run.mix["readback"], fence_stride=run.mix["fence_stride"])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.t1 = time.perf_counter()
    run.captures = kept


def release(run) -> None:
    run.state = None


def both_hit_taps(hit: torch.Tensor, passes: int) -> list:
    """Per pass, the (pixel, tap) pairs of the 5x5 stencil (edge-clamped)
    where both pixels hit."""
    h, w = hit.shape
    rows, cols = torch.arange(h, device=hit.device), torch.arange(w, device=hit.device)
    out = []
    for it in range(passes):
        step, both = 1 << it, 0
        for dy in range(-2, 3):
            ys = torch.clamp(rows + dy * step, 0, h - 1)
            for dx in range(-2, 3):
                xs = torch.clamp(cols + dx * step, 0, w - 1)
                both += int((hit & hit[ys][:, xs]).sum())
        out.append(both)
    return out


def reference_outputs(run, indices, dtype=torch.float32) -> dict:
    """The delivered frames ``indices`` as the plain reference in ``dtype``
    makes them: the beauty frame, the G-buffer, the filter, the tonemap.
    Counts the G-buffer's hits and both-hit taps for the floors."""
    mix, cfg = run.mix, run.config
    w, h, spp = mix["width"], mix["height"], mix["spp"]
    scene = run.config_module.reference_scene(cfg, run.device, dtype, cfg["time"])
    cam_args = camera(cfg, run.cell)
    cam = core.Camera.look_at(aspect_ratio=w / h, device=run.device, **cam_args).astype(dtype)
    g = denoise.cast_gbuffer(scene.nearest_hit, cam, w, h, cfg["sky"])
    if dtype == torch.float32:
        run.facts["gbuffer_hits"] = int(g.hit.sum())
        run.facts["both_hit_taps"] = both_hit_taps(g.hit, mix["denoise_passes"])
    batch = min(spp, max(1, MAX_RAYS // w))
    per_block = max(1, MAX_RAYS // (w * batch))
    frames = {}
    for idx in indices:
        offset = (mix["warm_frames"] + idx) * spp
        beauty = torch.cat([
            core.render_rows(scene.nearest_hit, cam, w, h, list(range(r, min(r + per_block, h))),
                             spp, cfg["bounces"], run.render_seed, cfg["sky"],
                             cam_args["aperture"] > 0.0, sample_offset=offset,
                             sample_batch=batch)[0]
            for r in range(0, h, per_block)])
        out = denoise.atrous(beauty, g, mix["denoise_passes"], **SIGMAS)
        frames[idx] = core.tonemap_u8(out.float(), cfg["gamma"]).cpu()
    return {"frames": frames, "order_gap": 0}


def program_outputs(run) -> dict:
    kept = run.captures
    frames = dict([kept["first"], kept["last"], *kept["reservoir"]])
    return {"frames": {i: torch.as_tensor(f).cpu() for i, f in frames.items()},
            "order_gap": kept["order"]}


def compared(got: dict, ref: dict) -> dict:
    return {"image_share": compare.share(compare.off_levels(got["frames"][i], ref["frames"][i])
                                         for i in ref["frames"]),
            "order_gap": got["order_gap"]}


def check(run) -> list:
    got = program_outputs(run)
    return compare.checks(compared(got, reference_outputs(run, sorted(got["frames"]))),
                          run.cell["limits"])


def control(run, dtype=torch.bfloat16) -> dict:
    """The control's numbers: the reference computed in ``dtype`` put in
    the program's place, on the frames this run checked."""
    indices = sorted(program_outputs(run)["frames"])
    return compared(reference_outputs(run, indices, dtype), reference_outputs(run, indices))
