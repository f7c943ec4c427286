"""Offline progressive rendering: ``PathTraceRenderer.draw_frame`` back to back.

The mix file gives the frame (``width``, ``height``, ``spp`` a frame) and
whether the renderer animates the scene to the configuration's frozen
``time`` every frame (``animate``: the tape is re-baked, reclustered on a
CPU copy and packed each frame) or the scene is baked at that time once. Frames
accumulate progressively; each ``draw_frame`` returns the tonemapped
image of the accumulation so far after reading the frame's segment count
back to the host. The loop is closed: the next frame is asked for when the
last has returned.

Set-up warms every shape the window uses (``warm_frames`` frames, long
enough that the card's clocks and the host have settled), then clears the
accumulation, so the window's frame k adds samples [k spp, (k + 1) spp).

The check (``check``) renders with the plain reference, on rows drawn from
the seed (``check.rows`` of them), frame 0, frame 1, ``RESERVOIR`` frames
drawn from the seed among the rest (reservoir sampling: the draw needs no
frame count beforehand) and the last frame. It compares:

- ``divergent_share``: the share of (pixel, frame) pairs whose radiance,
  the frame's difference of the program's accumulator, diverges from the
  reference's;
- ``image_share``: the share of the delivered image's pixels of frames 0
  and 1 (the accumulation of one and of two frames, tonemapped) off the
  reference's by more than one level;
- ``rays_gap``: the relative gap between the program's segment count of
  frame 0 and the reference's count of the whole frame;
- ``samples_gap``: the accumulator's sample count against the window's
  frames x spp, and its segment total against the frames' counts (exact).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import compare
from benchmark.harness import camera
from benchmark.reference import core

SPANS = ("draw_frame",)
ROWS_SALT = 0x5EED0001
RESERVOIR_SALT = 0x5EED0002
RESERVOIR = 2  # frames drawn from the seed among the window's third to last
RAYS_FRAME = 0  # the window frame whose segment count is held to the whole reference frame
MAX_RAYS = 1 << 21  # rays the reference traces at once


def _renderer(run):
    from csgrenderer_tpu_torch.app import PathTraceRenderer
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    mix, cfg = run.mix, run.config
    scene, animate = run.config_module.program_scene(cfg, run.device, mix["animate"], cfg["time"])
    cam_args = camera(cfg, run.cell)
    cam = Camera.look_at(aspect_ratio=mix["width"] / mix["height"], device=run.device, **cam_args)
    rc = RenderConfig(width=mix["width"], height=mix["height"], spp=mix["spp"],
                      max_bounces=cfg["bounces"], seed=run.render_seed, sky=cfg["sky"],
                      gamma=cfg["gamma"], lens=cam_args["aperture"] > 0.0)
    return PathTraceRenderer(scene, cam, rc, animate=animate, progressive=True,
                             device=run.device)


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(run) -> None:
    r = _renderer(run)
    for _ in range(run.mix["warm_frames"]):
        r.draw_frame(run.config["time"])
    _sync(run)
    r.reset_accumulation()
    run.state = r


def window(run, tracer) -> None:
    r, t = run.state, run.config["time"]
    rng = random.Random(run.seed ^ RESERVOIR_SALT)
    size = RESERVOIR
    early, reservoir = [], []
    prev = r.accumulator
    k = 0
    run.t0 = time.perf_counter()
    while True:
        with tracer.span("draw_frame"):
            image = r.draw_frame(t)
        now = time.perf_counter()
        acc = r.accumulator
        run.frames.append((now, r.last_frame_rays))
        if k < 2:
            early.append((k, prev, acc, image))
        elif len(reservoir) < size:
            reservoir.append((k, prev, acc))
        else:
            j = rng.randrange(k - 1)  # k - 2 candidates before this one, this one included
            if j < size:
                reservoir[j] = (k, prev, acc)
        last = (k, prev, acc)
        prev = acc
        k += 1
        if now - run.t0 >= run.loop_seconds:
            break
    _sync(run)
    run.t1 = time.perf_counter()
    run.captures = {"early": early, "reservoir": reservoir, "last": last,
                    "final": (r.accumulator.sample_count, r.accumulator.rays_traced)}


def release(run) -> None:
    run.state = None


def reference(run, dtype=torch.float32):
    """(hit object, camera) of the plain reference, in ``dtype``."""
    mix = run.mix
    scene = run.config_module.reference_scene(run.config, run.device, dtype,
                                                run.config["time"])
    cam = core.Camera.look_at(aspect_ratio=mix["width"] / mix["height"], device=run.device,
                              **camera(run.config, run.cell)).astype(dtype)
    return scene, cam


def render(run, scene, cam, rows, frame: int):
    """The reference's mean radiance [len(rows), W, 3] of window frame
    ``frame`` on ``rows``, and its segments, in blocks of rows."""
    mix, cfg = run.mix, run.config
    w, spp = mix["width"], mix["spp"]
    batch = min(spp, max(1, MAX_RAYS // w))
    per_block = max(1, MAX_RAYS // (w * batch))
    lens = camera(cfg, run.cell)["aperture"] > 0.0
    parts, rays = [], 0
    for b in range(0, len(rows), per_block):
        img, r = core.render_rows(scene.nearest_hit, cam, w, mix["height"], rows[b:b + per_block],
                                  spp, cfg["bounces"], run.render_seed, cfg["sky"], lens,
                                  sample_offset=frame * spp, sample_batch=batch)
        parts.append(img)
        rays += int(r)
    return torch.cat(parts), rays


def checked(run) -> tuple[list, dict]:
    """(rows drawn from the seed, {window frame: (accumulator before, after)})."""
    mix, chk, caps = run.mix, run.cell["check"], run.captures
    rows = sorted(random.Random(run.seed ^ ROWS_SALT).sample(range(mix["height"]),
                                                              min(chk["rows"], mix["height"])))
    frames = {k: (prev, acc) for k, prev, acc, _ in caps["early"]}
    frames.update({k: (prev, acc) for k, prev, acc in caps["reservoir"]})
    frames[caps["last"][0]] = caps["last"][1:]
    return rows, frames


def program_outputs(run, rows, frames) -> dict:
    """What the timed path produced, on the checked rows and frames: each
    frame's radiance (its accumulator difference over spp), the delivered
    images of frames 0 and 1, the segment count of frame ``RAYS_FRAME``,
    and the accumulator's totals against the window's frames (a gap)."""
    spp, caps = run.mix["spp"], run.captures
    count, total = caps["final"]
    return {
        "radiance": {k: (acc.radiance_sum[rows].double() - prev.radiance_sum[rows].double()) / spp
                     for k, (prev, acc) in frames.items()},
        "images": {k: image[rows].cpu() for k, _, _, image in caps["early"]},
        "rays": run.frames[RAYS_FRAME][1],
        "samples_gap": abs(int(count) - len(run.frames) * spp)
        + abs(int(total) - sum(r for _, r in run.frames)),
    }


def reference_outputs(run, rows, frames, dtype=torch.float32) -> dict:
    """The same outputs from the plain reference computed in ``dtype``: the
    images accumulate its frames' radiance as the renderer does (the sum
    of radiance x spp in float32, over the sample count), then tonemap."""
    spp = run.mix["spp"]
    scene, cam = reference(run, dtype)
    radiance = {k: render(run, scene, cam, rows, k)[0] for k in sorted(frames)}
    images, acc = {}, None
    for k in sorted(k for k in radiance if k < 2):
        term = radiance[k].float() * float(spp)
        acc = term if acc is None else acc + term
        n = torch.full((), float((k + 1) * spp), device=acc.device)
        images[k] = core.tonemap_u8(acc / n, run.config["gamma"]).cpu()
    _, rays = render(run, scene, cam, list(range(run.mix["height"])), RAYS_FRAME)
    return {"radiance": radiance, "images": images, "rays": rays, "samples_gap": 0}


def compared(got: dict, ref: dict) -> dict:
    return {"divergent_share": compare.share(
                compare.divergent(got["radiance"][k], ref["radiance"][k]) for k in ref["radiance"]),
            "image_share": compare.share(compare.off_levels(got["images"][k], ref["images"][k])
                                         for k in ref["images"]),
            "rays_gap": compare.relative_gap(got["rays"], ref["rays"]),
            "samples_gap": got["samples_gap"]}


def check(run) -> list:
    rows, frames = checked(run)
    return compare.checks(compared(program_outputs(run, rows, frames),
                                   reference_outputs(run, rows, frames)), run.cell["limits"])


def control(run, dtype=torch.bfloat16) -> dict:
    """The control's numbers: the reference computed in ``dtype`` put in
    the program's place, on the rows and frames this run checked."""
    rows, frames = checked(run)
    return compared(reference_outputs(run, rows, frames, dtype),
                    reference_outputs(run, rows, frames))
