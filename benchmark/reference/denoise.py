"""Plain torch G-buffer cast and edge-aware a-trous filter.

The G-buffer is one primary ray through each pixel centre, with no lens
sample: the distance to the first hit along the ray (t |d|, +inf on a
miss), the face-forwarded normal (0 on a miss), the albedo (the sky's
colour on a miss) and the hit mask. The filter is the a-trous wavelet
transform of Dammertz et al. (HPG 2010) with SVGF-style edge stops
(Schied et al., HPG 2017): passes of the 5x5 B3-spline stencil whose taps
dilate by 2^i, each tap weighted by how alike its normal (max(n.n', 0) to
the power sigma_n), depth and luminance are to the centre's, on the colour
divided by its albedo (clamped at 1e-4) and multiplied back after the last
pass. Taps beyond the frame take the edge pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .core import Camera, HitFn, dot, pixel_st, sky_color

B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
LUM = (0.2126, 0.7152, 0.0722)


class GBuffer(NamedTuple):
    depth: Tensor  # [H, W]
    normal: Tensor  # [H, W, 3]
    albedo: Tensor  # [H, W, 3]
    hit: Tensor  # [H, W] bool


def cast_gbuffer(hit_fn: HitFn, camera: Camera, width: int, height: int, sky: str) -> GBuffer:
    dev, dtype = camera.origin.device, camera.origin.dtype
    xs = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.int64, device=dev)[:, None]
    half = torch.full((), 0.5, dtype=dtype, device=dev)
    st_x, st_y = pixel_st(xs, ys, half, half, width, height)
    st_x, st_y = torch.broadcast_tensors(st_x, st_y)
    o, d = camera.rays(st_x, st_y, None)
    h = hit_fn(o, d)
    depth = torch.where(h.hit, h.t * torch.sqrt(dot(d, d)), torch.inf)
    normal = torch.where(h.hit[..., None], h.normal, 0.0)
    albedo = torch.where(h.hit[..., None], h.albedo, sky_color(d, sky))
    return GBuffer(depth, normal, albedo, h.hit)


def luminance(c: Tensor) -> Tensor:
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def atrous(color: Tensor, g: GBuffer, passes: int, sigma_color: float, sigma_normal: int,
           sigma_depth: float, color_sigma_decay: float) -> Tensor:
    """The demodulated filter of ``color`` [H, W, 3] (linear radiance).
    ``sigma_normal`` is a power of two, taken as that many squarings' worth:
    x^32 = ((((x^2)^2)^2)^2)^2."""
    squarings = int(sigma_normal).bit_length() - 1
    if 1 << squarings != int(sigma_normal):
        raise ValueError("the reference takes a power-of-two sigma_normal")
    albedo = torch.clamp(g.albedo, min=1e-4)
    depth = torch.where(torch.isfinite(g.depth), g.depth, 0.0)
    hit = g.hit.to(color.dtype)
    normal = g.normal
    h, w = depth.shape
    rows = torch.arange(h, device=color.device)
    cols = torch.arange(w, device=color.device)
    inv_z2 = 1.0 / (sigma_depth * sigma_depth + 1e-12)
    sig_c = float(sigma_color)
    work = color / albedo
    for it in range(passes):
        step = 1 << it
        inv_c2 = 1.0 / (sig_c * sig_c + 1e-12)
        sig_c /= color_sigma_decay
        lum_c = luminance(work)
        acc = torch.zeros_like(work)
        wsum = torch.zeros_like(depth)
        for iy, ky in enumerate(B3):
            ys = torch.clamp(rows + (iy - 2) * step, 0, h - 1)
            for ix, kx in enumerate(B3):
                xs = torch.clamp(cols + (ix - 2) * step, 0, w - 1)
                c_t, n_t, z_t, h_t = (x[ys][:, xs] for x in (work, normal, depth, hit))
                w_n = torch.clamp(dot(normal, n_t), min=0.0)
                for _ in range(squarings):
                    w_n = w_n * w_n
                w_n = torch.where(hit * h_t > 0.0, w_n, 1.0)
                dz = torch.abs(depth - z_t) / (0.5 * (depth + z_t) + 1e-3)
                dl = lum_c - luminance(c_t)
                w_z = torch.exp(-dz * dz * inv_z2)
                w_c = torch.exp(-dl * dl * inv_c2)
                w_h = torch.where(hit == h_t, 1.0, 0.0)
                wt = (ky * kx) * w_n * w_z * w_c * w_h
                acc = acc + wt[..., None] * c_t
                wsum = wsum + wt
        work = acc / torch.clamp(wsum, min=1e-8)[..., None]
    return work * albedo
