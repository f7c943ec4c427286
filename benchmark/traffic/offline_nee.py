"""Offline progressive rendering of a lamp-lit scene with next-event
estimation: ``offline_progressive`` with the renderer's NEE on.

It changes three things of ``offline_progressive`` and takes the rest
(the closed loop, its window, the rows and frames the check samples, the
four numbers it compares) as they are:

- the renderer is built with ``RenderConfig(nee=...)`` from the
  configuration's ``nee``, and refused at once by a program that does not
  count NEE's shadow rays (``PathTraceRenderer.last_frame_shadow_rays``);
- each window frame's shadow rays, which the renderer reads at the same
  fence as its segments, are recorded in ``run.facts["shadow_rays"]``
  (one count a frame, beside ``run.frames``);
- the plain reference is ``reference/nee.py``, and the check adds
  ``shadow_gap``: the relative gap between the program's shadow rays of
  frame 0 and the reference's of the whole frame.
"""

from __future__ import annotations

import torch

from benchmark import compare
from benchmark.harness import camera
from benchmark.reference import core, nee
from benchmark.traffic import offline_progressive as progressive

SPANS = progressive.SPANS
window = progressive.window
release = progressive.release


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
                      gamma=cfg["gamma"], lens=cam_args["aperture"] > 0.0, nee=cfg["nee"])
    r = PathTraceRenderer(scene, cam, rc, animate=animate, progressive=True, device=run.device)
    if not hasattr(r, "last_frame_shadow_rays"):
        raise RuntimeError("the program does not count NEE's shadow rays "
                           "(PathTraceRenderer.last_frame_shadow_rays): nothing to check them by")
    return r


def setup(run) -> None:
    r = _renderer(run)
    for _ in range(run.mix["warm_frames"]):
        r.draw_frame(run.config["time"])
    progressive._sync(run)
    r.reset_accumulation()
    shadows = run.facts["shadow_rays"] = []
    draw = r.draw_frame

    def draw_frame(time_sec):
        image = draw(time_sec)
        shadows.append(r.last_frame_shadow_rays)
        return image

    r.draw_frame = draw_frame
    run.state = r


def render(run, scene, cam, rows, frame: int):
    """The reference's mean radiance [len(rows), W, 3] of window frame
    ``frame`` on ``rows``, its segments and its shadow rays, in blocks of
    rows."""
    mix, cfg = run.mix, run.config
    w, spp = mix["width"], mix["spp"]
    batch = min(spp, max(1, progressive.MAX_RAYS // w))
    per_block = max(1, progressive.MAX_RAYS // (w * batch))
    lens = camera(cfg, run.cell)["aperture"] > 0.0
    parts, rays, shadow = [], 0, 0
    for b in range(0, len(rows), per_block):
        img, r, s = nee.render_rows(scene, cam, w, mix["height"], rows[b:b + per_block], spp,
                                    cfg["bounces"], run.render_seed, cfg["sky"], lens,
                                    sample_offset=frame * spp, sample_batch=batch)
        parts.append(img)
        rays += int(r)
        shadow += int(s)
    return torch.cat(parts), rays, shadow


def program_outputs(run, rows, frames) -> dict:
    """``offline_progressive``'s outputs and the shadow rays of frame
    ``RAYS_FRAME``."""
    return {**progressive.program_outputs(run, rows, frames),
            "shadow": run.facts["shadow_rays"][progressive.RAYS_FRAME]}


def reference_outputs(run, rows, frames, dtype=torch.float32) -> dict:
    """``offline_progressive.reference_outputs`` through the NEE reference,
    with its shadow rays of the whole frame ``RAYS_FRAME``."""
    spp = run.mix["spp"]
    scene, cam = progressive.reference(run, dtype)
    radiance = {k: render(run, scene, cam, rows, k)[0] for k in sorted(frames)}
    images, acc = {}, None
    for k in sorted(k for k in radiance if k < 2):
        term = radiance[k].float() * float(spp)
        acc = term if acc is None else acc + term
        n = torch.full((), float((k + 1) * spp), device=acc.device)
        images[k] = core.tonemap_u8(acc / n, run.config["gamma"]).cpu()
    _, rays, shadow = render(run, scene, cam, list(range(run.mix["height"])),
                             progressive.RAYS_FRAME)
    return {"radiance": radiance, "images": images, "rays": rays, "shadow": shadow,
            "samples_gap": 0}


def compared(got: dict, ref: dict) -> dict:
    return {**progressive.compared(got, ref),
            "shadow_gap": compare.relative_gap(got["shadow"], ref["shadow"])}


def check(run) -> list:
    rows, frames = progressive.checked(run)
    return compare.checks(compared(program_outputs(run, rows, frames),
                                   reference_outputs(run, rows, frames)), run.cell["limits"])


def control(run, dtype=torch.bfloat16) -> dict:
    """The control's numbers: the reference computed in ``dtype`` put in
    the program's place, on the rows and frames this run checked."""
    rows, frames = progressive.checked(run)
    return compared(reference_outputs(run, rows, frames, dtype),
                    reference_outputs(run, rows, frames))
