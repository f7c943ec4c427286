"""Edge-aware a-trous wavelet denoiser for path-traced frames.

Twin of ``csgrenderer_tpu/render/denoise.py``: the a-trous wavelet
transform (Dammertz et al., HPG 2010) with SVGF-style edge-stopping
functions (Schied et al., HPG 2017). N passes of one 5x5 B3-spline
stencil whose taps dilate by 2^i per pass, each tap weighted by how alike
its normal, depth and luminance are to the centre pixel's, with the
AOVs of render/aov.py. Albedo demodulation (filter colour / albedo,
remodulate after) keeps texture out of the filter.

``atrous_denoise`` runs the CUDA kernel of ``kernels/atrous.py`` (one
launch a pass; the first demodulates, the last remodulates) for CUDA
tensors, and ``atrous_denoise_plain``, the same arithmetic in torch ops,
for CPU tensors; nothing goes from one to the other. One operation differs
from the JAX package's in the last bits: the normal weight
max(n.n', 0)^sigma is a chain of squarings where sigma is a power of two
(JAX: a pow).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .aov import AOVs, render_aovs

# B3-spline 1D mass [1,4,6,4,1]/16; the 5x5 kernel is its outer product.
B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
LUM = (0.2126, 0.7152, 0.0722)


def luminance(c: Tensor) -> Tensor:
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def pass_constants(iterations: int, sigma_color: float, sigma_depth: float,
                   color_sigma_decay: float) -> list[tuple[int, float, float]]:
    """(step, 1 / sigma_c^2, 1 / sigma_z^2) of each pass, as Python floats
    (one rounding to float32 where they meet the image)."""
    out, sig_c = [], float(sigma_color)
    inv_sig_z2 = 1.0 / (sigma_depth * sigma_depth + 1e-12)
    for it in range(iterations):
        out.append((1 << it, 1.0 / (sig_c * sig_c + 1e-12), inv_sig_z2))
        sig_c /= color_sigma_decay
    return out


def normal_squarings(sigma_normal: float) -> int:
    """k where ``sigma_normal`` is 2^k (1, 2, 4, ...), so that
    max(n.n', 0)^sigma is k squarings; -1 for any other exponent (a pow)."""
    s = float(sigma_normal)
    if s >= 1.0 and s.is_integer() and int(s) & (int(s) - 1) == 0:
        return int(s).bit_length() - 1
    return -1


def filter_inputs(aovs: AOVs) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(albedo clamped at 1e-4, normal, depth with misses at 0, hit as
    float32): the filter's inputs. A miss carries depth +inf; at 0 sky
    pixels blend among themselves (dz = 0), while the hit gate keeps them
    from geometry."""
    depth = aovs.depth.float()
    return (torch.clamp(aovs.albedo.float(), min=1e-4), aovs.normal.float(),
            torch.where(torch.isfinite(depth), depth, 0.0), aovs.hit.float())


def atrous_pass_plain(work: Tensor, normal: Tensor, depth: Tensor, hit: Tensor, step: int,
                      inv_sig_c2: float, inv_sig_z2: float, sigma_normal: float) -> Tensor:
    """One pass of the filter on [H, W, 3] ``work``: the plain version of
    the kernel's pass. Taps outside the image take the edge pixel (clamped
    coordinates, ``jnp.pad(mode="edge")``)."""
    h, w = depth.shape
    squarings = normal_squarings(sigma_normal)
    lum_c = luminance(work)
    acc = torch.zeros_like(work)
    wsum = torch.zeros_like(depth)
    rows = torch.arange(h, device=work.device)
    cols = torch.arange(w, device=work.device)
    for iy, ky in enumerate(B3):
        ys = torch.clamp(rows + (iy - 2) * step, 0, h - 1)
        for ix, kx in enumerate(B3):
            xs = torch.clamp(cols + (ix - 2) * step, 0, w - 1)
            c_t, n_t, z_t, h_t = (x[ys][:, xs] for x in (work, normal, depth, hit))
            n_dot = normal[..., 0] * n_t[..., 0] + normal[..., 1] * n_t[..., 1] \
                + normal[..., 2] * n_t[..., 2]
            w_n = torch.clamp(n_dot, min=0.0)
            if squarings < 0:
                w_n = w_n ** sigma_normal
            for _ in range(squarings):
                w_n = w_n * w_n
            # sky pixels (normal 0) zero w_n; the hit gate decides for them
            w_n = torch.where(hit * h_t > 0.0, w_n, 1.0)
            dz = torch.abs(depth - z_t) / (0.5 * (depth + z_t) + 1e-3)
            dl = lum_c - luminance(c_t)
            w_z = torch.exp(-dz * dz * inv_sig_z2)
            w_c = torch.exp(-dl * dl * inv_sig_c2)
            w_h = torch.where(hit == h_t, 1.0, 0.0)
            wt = (ky * kx) * w_n * w_z * w_c * w_h
            acc = acc + wt[..., None] * c_t
            wsum = wsum + wt
    return acc / torch.clamp(wsum, min=1e-8)[..., None]


def atrous_denoise_plain(color: Tensor, aovs: AOVs, iterations: int = 4,
                         sigma_color: float = 2.0, sigma_normal: float = 32.0,
                         sigma_depth: float = 0.15, color_sigma_decay: float = 2.0,
                         demodulate: bool = True) -> Tensor:
    """``atrous_denoise`` in torch ops, on any device (see there)."""
    if iterations < 1:
        return color
    albedo, normal, depth, hit = filter_inputs(aovs)
    work = color.float()
    if demodulate:
        work = work / albedo
    for step, inv_sig_c2, inv_sig_z2 in pass_constants(iterations, sigma_color, sigma_depth,
                                                       color_sigma_decay):
        work = atrous_pass_plain(work, normal, depth, hit, step, inv_sig_c2, inv_sig_z2,
                                 sigma_normal)
    if demodulate:
        work = work * albedo
    return work


def atrous_denoise(color: Tensor, aovs: AOVs, iterations: int = 4, sigma_color: float = 2.0,
                   sigma_normal: float = 32.0, sigma_depth: float = 0.15,
                   color_sigma_decay: float = 2.0, demodulate: bool = True) -> Tensor:
    """Denoise a linear-radiance image [H, W, 3] with its AOVs as edge stops.

    - ``sigma_color``: luminance tolerance (larger = smoother); divided by
      ``color_sigma_decay`` after each pass, so the later, wider passes
      keep the detail the earlier ones established.
    - ``sigma_normal``: exponent on ``max(0, n.n')``: higher, harder
      normal edges.
    - ``sigma_depth``: relative depth tolerance (|dz| / mean depth).
    - ``demodulate``: filter colour / albedo, remodulate after.

    Returns the denoised linear image, float32. A CUDA ``color`` runs the
    CUDA kernel (or raises), a CPU one the plain version.
    """
    if color.device.type == "cpu":
        return atrous_denoise_plain(color, aovs, iterations, sigma_color, sigma_normal,
                                    sigma_depth, color_sigma_decay, demodulate)
    # imported here: kernels/ imports render/ (the scene types its packers
    # read), so a module-level import would be circular
    from ..kernels.atrous import atrous_passes

    if iterations < 1:
        return color
    return atrous_passes(color, aovs.normal, aovs.depth, aovs.hit,
                         pass_constants(iterations, sigma_color, sigma_depth, color_sigma_decay),
                         sigma_normal, albedo=aovs.albedo if demodulate else None)


def denoise_frame(color: Tensor, hit_fn, camera, sky: str = "rtiow",
                  row_chunk: int | None = None, **kwargs) -> Tensor:
    """Render the AOVs for ``camera`` at the image's resolution and
    a-trous-denoise ``color`` with them. ``sky`` must be the beauty
    frame's sky mode (the albedo of a miss is the sky colour)."""
    h, w = color.shape[0], color.shape[1]
    aovs = render_aovs(hit_fn, camera, w, h, sky=sky, row_chunk=row_chunk)
    return atrous_denoise(color, aovs, **kwargs)
