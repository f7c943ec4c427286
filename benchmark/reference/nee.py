"""Plain torch next-event estimation toward emissive sphere lamps: the
benchmark's reference for lamp-lit sphere scenes.

Written from the published estimator: light sampling combined with the
scatter by multiple importance sampling, as *Ray Tracing: The Rest of
Your Life* (Shirley, raytracing.github.io) builds it, with Veach's
balance heuristic (thesis, 1997, section 9.2), on the RTIOW materials of
``core.py``. A path gathers light three ways:

- a camera ray, or a ray leaving a glass or mirror vertex, that hits a
  lamp (material kind 4) takes its emission in full, and the path ends;
- at every Lambertian or glossy-metal hit, one lamp is picked uniformly
  (probability 1/L), a direction is drawn uniform in the cone the lamp's
  sphere subtends (pdf 1 / (2 pi (1 - cos theta_max))) and a shadow ray
  is traced along it. The lamp is occluded iff the scene's nearest hit
  lies below tl (1 - 1e-4), tl the analytic distance to the sampled lamp:
  no sphere identity is compared. An unoccluded sample adds
  albedo Le q / (1 + q), q = pdf_b L 2 pi (1 - cos theta_max): the
  balance-heuristic weight pdf_L / (pdf_L + pdf_b) times Le times the
  BRDF over pdf_L, with the BRDF written as albedo pdf_b;
- a lamp reached by a Lambertian or glossy scatter keeps the partner
  weight q / (q + 1), q from the pdf of that scatter, so the two
  strategies sum to one estimator.

Counter keys of the uniforms, as the renderer documents them (its NEE
docstring in ``render/lights.py`` and the ``NEE_BIT`` key of its bounce
loop): the scatter's (pixel, sample, bounce, seed), the lamp sample's
(pixel, sample, bounce | 0x80000000, seed); of the lamp sample, u0 picks
the lamp (floor(u0 L), at most L - 1), u1 the azimuth 2 pi u1, u2 the
cosine 1 + u2 (cos theta_max - 1).

Departures from the book, each the renderer's documented rule:

- the Lambertian lobe is RTIOW's n + a unit vector, whose pdf is cos / pi;
- metal with fuzz above 1e-4 ("glossy") pairs with the lamp sample: its
  lobe pdf is the density of reflect(d) + fuzz u, u uniform on the unit
  sphere (``metal_pdf``); mirror metal and glass are deltas and do not
  pair. A lamp sample below a glossy vertex's horizon carries nothing;
- the lamp a scatter reached is the lamp whose surface lies nearest the
  hit point (the least |dist - r|), the lowest index on a tie;
- a lamp sample from inside its lamp has no cone and is dropped, and the
  cone's orthonormal basis is Frisvad's branchless one (Duff et al. 2017);
- paths that reach the bounce cap gather nothing more (RTIOW);
- float grouping as ``core.py`` states it: dot products left to right,
  correctly rounded square roots, so that where the program is right the
  two agree but for paths that split at a silhouette.

Every function takes its float type from its inputs (the lower-precision
control computes in bfloat16). It counts traced segments and, apart from
them, shadow rays: a shadow ray is traced where a lamp sample is usable
(a positive lobe pdf toward it, a cone, the lamp hit along it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from . import core
from .core import MASK, dot, normalized, sqrt
from .spheres import SphereSoup

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EMISSIVE = 4
NEE_BIT = 0x80000000  # bounce-counter bit of the lamp sample's uniforms
GLOSSY_FUZZ = 1e-4  # metal with fuzz above this pairs with the lamp sample
SHADOW_SCALE = 1.0 - 1e-4  # occluded iff the nearest hit lies below tl * this
OUTSIDE_SCALE = 1.0 + 1e-6  # a point is outside a lamp iff dist^2 > r^2 * this
LAMP_MISS = 1e30  # the analytic lamp distance of a miss
LAMP_MISS_CUT = 1e29  # a lamp distance at or past this is a miss
T_MIN = 1e-3  # t_min of the analytic lamp hit, as of every segment


class Lamps(NamedTuple):
    centers: Tensor  # [L, 3]
    radii: Tensor  # [L], positive
    emit: Tensor  # [L, 3]

    @staticmethod
    def of(scene: SphereSoup) -> "Lamps":
        """The scene's emissive spheres, in scene order."""
        ids = torch.nonzero(scene.mat_kind == EMISSIVE)[:, 0]
        if ids.numel() == 0:
            raise ValueError("the scene has no emissive sphere to sample")
        return Lamps(scene.centers[ids], torch.abs(scene.radii[ids]), scene.albedo[ids])

    @property
    def count(self) -> int:
        return self.centers.shape[0]


def _cone(to_c: Tensor, r: Tensor):
    """(dist2, cos_theta_max, outside) of a lamp of radius r at to_c."""
    dist2 = dot(to_c, to_c)
    r2 = r * r
    cos_max = sqrt(torch.clamp(1.0 - r2 / torch.clamp(dist2, min=1e-20), min=0.0))
    return dist2, cos_max, dist2 > r2 * OUTSIDE_SCALE


def sample_cone(p: Tensor, c: Tensor, r: Tensor, u1: Tensor, u2: Tensor):
    """(unit direction [..., 3], 1 / pdf = 2 pi (1 - cos theta_max), 0 from
    inside the lamp) of a direction uniform in the cone of sphere (c, r)."""
    to_c = c - p
    _, cos_max, outside = _cone(to_c, r)
    z = 1.0 + u2 * (cos_max - 1.0)
    phi = (2.0 * math.pi) * u1
    sin_t = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    w = normalized(to_c, eps=1e-20)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    one = torch.ones_like(wz)
    sign = torch.where(wz >= 0.0, one, -one)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    t0 = torch.stack([1.0 + sign * wx * wx * a, sign * b, -sign * wx], dim=-1)
    t1 = torch.stack([b, sign + wy * wy * a, -wy], dim=-1)
    d = (torch.cos(phi) * sin_t)[..., None] * t0 + (torch.sin(phi) * sin_t)[..., None] * t1 \
        + z[..., None] * w
    return d, torch.where(outside, (2.0 * math.pi) * (1.0 - cos_max), 0.0)


def lamp_distance(p: Tensor, d: Tensor, c: Tensor, r: Tensor) -> Tensor:
    """The nearest t > T_MIN of the unit ray (p, d) on sphere (c, r), or
    LAMP_MISS (a negative discriminant's root is NaN, which no test keeps)."""
    oc = p - c
    half_b = dot(oc, d)
    disc = half_b * half_b - (dot(oc, oc) - r * r)
    sq = sqrt(disc)
    t0, t1 = -half_b - sq, -half_b + sq
    t = torch.where(t0 > T_MIN, t0, t1)
    return torch.where(t > T_MIN, t, LAMP_MISS)


def lambertian_pdf(n: Tensor, d: Tensor) -> Tensor:
    """Solid-angle pdf cos / pi of the cosine lobe toward d (any length)."""
    return torch.clamp(dot(n, normalized(d, eps=1e-20)), min=0.0) * (1.0 / math.pi)


def metal_pdf(d_in: Tensor, n: Tensor, fuzz: Tensor, d: Tensor) -> Tensor:
    """Solid-angle pdf toward d of the fuzzy-metal scatter reflect(d_in) +
    fuzz u, u uniform on the unit sphere: with c = w . r (w the unit d, r
    the unit mirror direction) and g = sqrt(c^2 - 1 + f^2), the endpoint's
    density on the radius-f sphere around r, carried to directions,
    (t+^2 [t+ > 0] + t-^2 [t- > 0]) / (4 pi f g), t+- = c +- g; 0 outside
    the lobe and for mirror metal (f <= GLOSSY_FUZZ, a delta)."""
    ud = normalized(d_in, eps=1e-20)
    r = ud - 2.0 * dot(ud, n)[..., None] * n
    c = dot(normalized(d, eps=1e-20), r)
    f = torch.clamp(fuzz, min=GLOSSY_FUZZ)
    g2 = c * c - 1.0 + f * f
    g = sqrt(torch.clamp(g2, min=1e-20))
    tp, tm = c + g, c - g
    num = torch.where(tp > 0.0, tp * tp, 0.0) + torch.where(tm > 0.0, tm * tm, 0.0)
    pdf = num / ((4.0 * math.pi) * f * g)
    return torch.where((fuzz > GLOSSY_FUZZ) & (g2 > 0.0), pdf, 0.0)


def partner_weight(lamps: Lamps, o_prev: Tensor, p: Tensor, prev_pdf: Tensor) -> Tensor:
    """q / (q + 1), q = prev_pdf L 2 pi (1 - cos theta_max) of the lamp
    holding p, seen from the scatter's origin o_prev (inside it: weight 1)."""
    dvec = p[..., None, :] - lamps.centers  # [..., L, 3]
    li = torch.argmin(torch.abs(sqrt(dot(dvec, dvec)) - lamps.radii), dim=-1)
    _, cos_max, outside = _cone(lamps.centers[li] - o_prev, lamps.radii[li])
    inv_pdf = torch.where(outside, (2.0 * math.pi) * (1.0 - cos_max), LAMP_MISS)
    q = prev_pdf * lamps.count * inv_pdf
    return q / (q + 1.0)


def lamp_sample(hit_fn, lamps: Lamps, h: core.Hit, p: Tensor, d_in: Tensor, u: Tensor,
                lam: Tensor, glossy: Tensor, at: Tensor):
    """(direct light [..., 3], shadow rays traced [...]) of the lamp sample
    at the hits ``at`` (Lambertian ``lam`` or ``glossy``) of points p: the
    MIS-weighted albedo Le q / (1 + q) of an unoccluded sample, 0 else."""
    nl = lamps.count
    li = torch.clamp((u[..., 0] * nl).to(torch.int32), max=nl - 1).to(torch.int64)
    c, r, e = lamps.centers[li], lamps.radii[li], lamps.emit[li]
    d, inv_pdf = sample_cone(p, c, r, u[..., 1], u[..., 2])
    cos = dot(h.normal, d)
    pdf_lam = torch.clamp(cos, min=0.0) * (1.0 / math.pi)
    pdf_met = torch.where(cos > 0.0, metal_pdf(d_in, h.normal, h.mat_param, d), 0.0)
    pdf_b = torch.where(lam, pdf_lam, torch.where(glossy, pdf_met, 0.0))
    tl = lamp_distance(p, d, c, r)
    traced = at & (pdf_b > 0.0) & (inv_pdf > 0.0) & (tl < LAMP_MISS_CUT)
    lit = traced
    if bool(traced.any()):
        sh = core._trace_active(hit_fn, p, d, traced)
        lit = traced & ~(sh.hit & (sh.t < tl * SHADOW_SCALE))
    q = pdf_b * nl * inv_pdf
    scale = torch.where(lit, q / (1.0 + q), 0.0)
    return h.albedo * e * scale[..., None], traced


def trace_paths(scene: SphereSoup, lamps: Lamps, o: Tensor, d: Tensor, pixel_id: Tensor,
                sample_id, seed: int, max_bounces: int, sky: str):
    """(radiance [..., 3], traced segments, shadow rays), int64 counts."""
    hit_fn = scene.nearest_hit
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    active = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    prev_pdf = torch.zeros(o.shape[:-1], dtype=o.dtype, device=o.device)  # 0: full emission
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    shadow = torch.zeros((), dtype=torch.int64, device=o.device)
    for b in range(max_bounces):
        if b and not bool(active.any()):
            break
        h = core._trace_active(hit_fn, o, d, active)
        u = core.uniform4(pixel_id, sample_id, b, seed & MASK, o.dtype)
        direction, attenuation, absorbed = core.scatter(h, d, u)
        missed = active & ~h.hit
        hit_active = active & h.hit
        radiance = radiance + torch.where(missed[..., None], throughput * core.sky_color(d, sky),
                                          0.0)
        t_safe = torch.where(h.hit, h.t, torch.ones_like(h.t))
        p_hit = o + t_safe[..., None] * d

        emissive = h.mat_kind == EMISSIVE
        paired = emissive & (prev_pdf > 0.0)
        emitted = throughput * torch.where(emissive[..., None], h.albedo, 0.0)
        emitted = emitted * torch.where(paired, partner_weight(lamps, o, p_hit, prev_pdf),
                                        1.0)[..., None]
        radiance = radiance + torch.where(hit_active[..., None], emitted, 0.0)

        lam = h.mat_kind == 1
        glossy = (h.mat_kind == 2) & (h.mat_param > GLOSSY_FUZZ)
        at = hit_active & (lam | glossy)
        ul = core.uniform4(pixel_id, sample_id, b | NEE_BIT, seed & MASK, o.dtype)
        direct, traced = lamp_sample(hit_fn, lamps, h, p_hit, d, ul, lam, glossy, at)
        radiance = radiance + torch.where(at[..., None], throughput * direct, 0.0)
        shadow = shadow + traced.sum(dtype=torch.int64)

        throughput = torch.where(hit_active[..., None], throughput * attenuation, throughput)
        rays = rays + active.sum(dtype=torch.int64)
        active = hit_active & ~absorbed & ~emissive
        prev_pdf = torch.where(active & lam, lambertian_pdf(h.normal, direction),
                               torch.where(active & glossy,
                                           metal_pdf(d, h.normal, h.mat_param, direction), 0.0))
        o = torch.where(hit_active[..., None], p_hit, o)
        d = torch.where(hit_active[..., None], direction, d)
    return radiance, rays, shadow


def render_rows(scene: SphereSoup, camera: core.Camera, width: int, height: int, rows, spp: int,
                max_bounces: int, seed: int, sky: str, lens: bool, sample_offset: int,
                sample_batch: int = 1) -> tuple[Tensor, Tensor, Tensor]:
    """``core.render_rows`` with the lamp sample: the mean radiance
    [len(rows), width, 3] of the frame's ``rows``, their traced segments
    and their shadow rays."""
    dev, dtype = camera.origin.device, camera.origin.dtype
    lamps = Lamps.of(scene)
    ys = torch.as_tensor(rows, dtype=torch.int64, device=dev).reshape(-1, 1)
    xs = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pixel_id = ys * width + xs
    acc = torch.zeros((ys.shape[0], width, 3), dtype=dtype, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    for first in range(0, spp, sample_batch):
        n = min(sample_batch, spp - first)
        s = (torch.arange(first, first + n, dtype=torch.int64, device=dev)
             + int(sample_offset)) & MASK
        s = int(s[0]) if n == 1 else s[:, None, None]
        u = core.uniform4(pixel_id, s, core.JITTER_KEY, seed, dtype)
        st_x, st_y = core.pixel_st(xs, ys, u[..., 0], u[..., 1], width, height)
        lens_uv = None
        if lens:
            r = torch.sqrt(u[..., 2])
            phi = (2.0 * math.pi) * u[..., 3]
            lens_uv = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
        o, d = camera.rays(st_x, st_y, lens_uv)
        radiance, r_count, s_count = trace_paths(scene, lamps, o, d, pixel_id, s, seed,
                                                 max_bounces, sky)
        for one in (radiance,) if n == 1 else radiance.unbind(0):
            acc = acc + one
        rays = rays + r_count
        shadow = shadow + s_count
    return acc / spp, rays, shadow
