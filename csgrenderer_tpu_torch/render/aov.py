"""Primary-visibility AOVs (arbitrary output variables): the G-buffer.

Twin of ``csgrenderer_tpu/render/aov.py``. Every scene type exposes one
``hit_fn(o, d) -> SurfaceHit`` (render/integrator.py), so the AOV pass is
one batched primary-ray cast through it: depth, the face-forwarded shading
normal, the albedo and the hit mask of each pixel, the edge-stopping
inputs of the a-trous filter (render/denoise.py).

Rays go through pixel centres with no lens sample, so the G-buffer is
deterministic and its channels are free of noise; the aperture blur stays in
the beauty frame. The hit functions are the plain torch ones
(``SphereScene.nearest_hit``, ``integrator.tape_hit_adapter``,
``MeshScene.nearest_hit``), on the tensors' device: the JAX package's AOV
pass is a jnp program too, not a Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..math import vec
from .integrator import sky_color


class AOVs(NamedTuple):
    """Per-pixel auxiliary channels, all [H, W(, C)] float32 / bool."""

    depth: Tensor  # [H, W] euclidean distance to the first hit (t * |d|,
    #                camera directions are unnormalised); +inf on a miss
    normal: Tensor  # [H, W, 3] face-forwarded unit shading normal; 0 on a miss
    albedo: Tensor  # [H, W, 3] material base colour; the sky colour on a miss
    hit: Tensor  # [H, W] bool: the primary ray hit a surface


def render_aovs(hit_fn, camera, width: int, height: int, sky: str = "rtiow",
                row_chunk: int | None = None) -> AOVs:
    """Cast one centred primary ray per pixel and record the G-buffer.

    ``camera`` is a ``Camera`` (its lens is ignored, see the module
    docstring); the st convention is the integrator's, so AOV pixels align
    with beauty pixels. ``sky`` must be the beauty frame's sky mode, or
    the albedo of a miss is the wrong colour.

    ``row_chunk``: cast that many rows at a time (rounded down to the
    largest divisor of ``height``), which bounds the [rays x primitives]
    planes of a brute hit function.
    """
    dev = camera.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height

    def block(st_y: Tensor):
        st_x = xs[None, :].expand(st_y.shape[0], width)
        o, d = camera.rays(st_x, st_y[:, None].expand(st_y.shape[0], width))
        h = hit_fn(o, d)
        depth = torch.where(h.hit, h.t * vec.length(d), torch.inf)
        normal = torch.where(h.hit[..., None], h.normal, 0.0)
        albedo = torch.where(h.hit[..., None], h.albedo, sky_color(d, sky))
        return depth.float(), normal.float(), albedo.float(), h.hit

    if row_chunk is None or row_chunk >= height:
        return AOVs(*block(ys))
    rc = int(row_chunk)
    while height % rc:  # the largest divisor <= the request
        rc -= 1
    parts = [block(ys[r:r + rc]) for r in range(0, height, rc)]
    return AOVs(*(torch.cat(p) for p in zip(*parts)))
