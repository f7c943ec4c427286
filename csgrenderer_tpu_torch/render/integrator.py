"""Path-tracing integrator: the plain torch reference path.

Twin of ``csgrenderer_tpu/render/integrator.py`` (sphere scenes, and CSG
tapes through ``tape_hit_adapter``). The
whole pixel grid is one batched tensor program: ray generation broadcasts
over [H, W] rays, the bounce loop carries (origin, direction, throughput,
radiance, active) per ray, and samples accumulate in an outer loop. RNG
counters are functions of global pixel coordinates, so any tiling of the
image composes to the same result.

This is what the CUDA kernels (``kernels/megakernel.py``,
``kernels/tape_kernel.py``) are held against, through their hit
functions, and what runs for tensors that lie on the CPU. ``lights=``
(``render/lights.py``) adds next-event estimation with MIS.

``render_wololo_frame`` and ``render_debug_view_1`` are the milestone-01
frame and the st-coordinate view of the reference shader, plain torch ops
on any device (XLA programs in the JAX package, not Pallas kernels).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, NamedTuple

import torch
from torch import Tensor

from ..camera.pinhole import WololoCamera, pixel_st_grid
from ..math import vec
from . import intersect, lights as lamps, materials, tape_eval
from .sampling import sample_in_unit_disk, uniform4

WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
SKY_MODES = ("rtiow", "wololo", "black")
NEE_BIT = 0x80000000  # bounce-counter bit of the NEE uniforms: decoupled from the scatter's


def sky_color(d: Tensor, mode: str = "rtiow") -> Tensor:
    """Background gradient.

    - ``"wololo"``: the reference's t = unit_d.y (not RTIOW's 0.5*(y+1)),
      a quirk kept for bit-comparable milestone images.
    - ``"rtiow"``: t = 0.5 * (unit_d.y + 1) (the book's gradient).
    - ``"black"``: no sky (emissive-lit scenes).
    """
    unit = vec.normalized(d, eps=1e-20)
    y = unit[..., 1]
    if mode == "wololo":
        t = y
    elif mode == "rtiow":
        t = 0.5 * (y + 1.0)
    elif mode == "black":
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    else:
        raise ValueError(f"unknown sky mode {mode!r}")
    # vec.lerp's operations channel by channel, with the colours as Python
    # floats: no host-to-device copy, so a frame on the card never waits
    return torch.stack([(1.0 - t) * a + t * b for a, b in zip(WHITE, SKY_BLUE)], dim=-1)


class SurfaceHit(NamedTuple):
    t: Tensor  # [...]
    hit: Tensor  # [...] bool
    normal: Tensor  # [..., 3] unit, opposing the incoming ray
    front_face: Tensor  # [...] bool (ray entered the solid from outside)
    mat_kind: Tensor  # [...] int32
    albedo: Tensor  # [..., 3]
    mat_param: Tensor  # [...]


@dataclass(frozen=True)
class SphereScene:
    """Struct-of-arrays sphere soup with per-sphere materials.

    A negative radius flips the outward normal: the RTIOW hollow-bubble
    trick (a sphere inside a glass sphere).
    """

    centers: Tensor  # [S, 3] f32
    radii: Tensor  # [S] f32
    mat_kind: Tensor  # [S] int32
    albedo: Tensor  # [S, 3] f32
    mat_param: Tensor  # [S] f32

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def to(self, device) -> "SphereScene":
        return SphereScene(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def surface_hit(self, o: Tensor, d: Tensor, t: Tensor, idx: Tensor, hit: Tensor) -> SurfaceHit:
        """Shading inputs at the nearest hit (t, idx, hit) of flat rays [N,3]."""
        t_safe = torch.where(hit, t, torch.ones_like(t))
        p = o + t_safe[:, None] * d
        outward = (p - self.centers[idx]) / self.radii[idx][:, None]
        front_face = vec.dot(d, outward) < 0.0
        n = torch.where(front_face[:, None], outward, -outward)
        return SurfaceHit(
            t=t,
            hit=hit,
            normal=n,
            front_face=front_face,
            mat_kind=self.mat_kind[idx],
            albedo=self.albedo[idx],
            mat_param=self.mat_param[idx],
        )

    def nearest_hit(self, o: Tensor, d: Tensor, eps: float = 1e-3) -> SurfaceHit:
        batch = o.shape[:-1]
        flat_o = o.reshape(-1, 3)
        flat_d = d.reshape(-1, 3)
        t, idx, hit = intersect.spheres_nearest_hit(
            flat_o, flat_d, self.centers, self.radii, t_min=eps
        )
        h = self.surface_hit(flat_o, flat_d, t, idx, hit)
        return SurfaceHit(*(x.reshape(batch + x.shape[1:]) for x in h))


def tape_hit_adapter(tape, o: Tensor, d: Tensor, eps: float = 1e-3) -> SurfaceHit:
    """The reference CSG hit (interval lists) as a ``SurfaceHit``.

    The leaf normal is face-forwarded against the ray by ``dot(d, n) > 0``;
    ``front_face`` is the solid-level ``entering`` flag, right even on
    subtracted surfaces where a dot-product test is not.
    """
    h = tape_eval.tape_nearest_hit(tape, o, d, eps=eps)
    flip = vec.dot(d, h.normal) > 0.0
    n = torch.where(flip[..., None], -h.normal, h.normal)
    return SurfaceHit(
        t=h.t,
        hit=h.hit,
        normal=n,
        front_face=h.entering,
        mat_kind=h.mat_kind,
        albedo=h.albedo,
        mat_param=h.mat_param,
    )


HitFn = Callable[[Tensor, Tensor], SurfaceHit]


def _trace_active(hit_fn: HitFn, o: Tensor, d: Tensor, active: Tensor) -> SurfaceHit:
    """``hit_fn`` on the active rays only, the segments a kernel traces (so
    a hit function's work counters count that work); the ended paths get
    a miss with zero attributes, which the bounce loop masks out."""
    if bool(active.all()):
        return hit_fn(o, d)
    idx = torch.nonzero(active.reshape(-1))[:, 0]
    h = hit_fn(o.reshape(-1, 3)[idx], d.reshape(-1, 3)[idx])

    def full(x: Tensor) -> Tensor:
        out = torch.zeros((active.numel(),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        out[idx] = x
        return out.reshape(active.shape + tuple(x.shape[1:]))

    return SurfaceHit(*(full(x) for x in h))


def trace_paths(
    hit_fn: HitFn,
    o: Tensor,  # [..., 3]
    d: Tensor,  # [..., 3]
    pixel_id: Tensor,  # [...] integer: stable global pixel index
    sample_id,  # int or integer tensor
    seed: int,
    max_bounces: int,
    sky: str = "rtiow",
    eps: float = 1e-3,
    lights=None,
    counts: dict | None = None,
    shadow_hit_fn: HitFn | None = None,
) -> tuple[Tensor, Tensor]:
    """Iterative bounce loop. Returns (radiance [..., 3], rays traced int64 []).

    ``rays`` counts traced segments: the active rays of every bounce (NEE
    shadow rays are not counted). Only those segments go to ``hit_fn``;
    the loop ends early once every path has ended.

    ``lights`` (``SphereLights`` or ``TriLights``) enables MIS next-event
    estimation: every Lambertian or glossy-metal hit also samples one lamp
    through a shadow ray (uniforms keyed by ``bounce | NEE_BIT``), and lamp
    emission reached by such a vertex's scatter carries the partner weight,
    from the pdf of that scatter carried along the path (0 on camera rays
    and after other vertices: emission then counts in full).

    ``counts``: a dict to which the NEE work is added as int64 tensors:
    lamp samples (``nee_vertices``), shadow rays traced (``shadow_rays``)
    and those that found the lamp unoccluded (``shadow_clear``),
    MIS-weighted lamp hits (``mis_emission``) and scatter pdfs carried
    (``carried_pdfs``): the work a kernel taking the same decisions does.

    ``shadow_hit_fn``: the hit function of NEE's shadow rays, where it is
    not ``hit_fn`` (the tape kernel's audit mode traces its path segments
    through interval lists and its shadow rays by event flip).

    ``eps`` is accepted and ignored, as in the JAX package: the hit
    function carries its own t_min.
    """
    throughput = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    active = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    prev_pdf_b = torch.zeros(o.shape[:-1], dtype=torch.float32, device=o.device)

    def count(key, mask):
        if counts is not None:
            counts[key] = counts.get(key, 0) + mask.sum(dtype=torch.int64)

    for b in range(max_bounces):
        if b and not bool(active.any()):
            break  # every path has ended: later bounces add nothing
        h = _trace_active(hit_fn, o, d, active)
        u = uniform4(pixel_id, sample_id, b, seed & 0xFFFFFFFF)
        sc = materials.scatter(h.mat_kind, h.albedo, h.mat_param, d, h.normal, h.front_face, u)
        missed = active & ~h.hit
        hit_active = active & h.hit

        radiance = radiance + torch.where(missed[..., None], throughput * sky_color(d, sky), 0.0)
        t_safe = torch.where(h.hit, h.t, torch.ones_like(h.t))
        p_hit = o + t_safe[..., None] * d
        emitted = throughput * sc.emitted
        if lights is not None:
            # the partner weight on lamp emission (kind 4) found by a pairable scatter
            w_b = lamps.bsdf_mis_scale_any(lights, o, p_hit, prev_pdf_b)
            paired = (h.mat_kind == 4) & (prev_pdf_b > 0.0)
            emitted = emitted * torch.where(paired, w_b, 1.0)[..., None]
            count("mis_emission", hit_active & paired)
        radiance = radiance + torch.where(hit_active[..., None], emitted, 0.0)

        is_lam = h.mat_kind == 1
        # glossy = fuzzy metal: its lobe has a pdf to pair with; mirror metal
        # is a delta, which NEE cannot sample
        is_glossy = (h.mat_kind == 2) & (h.mat_param > 1e-4)
        if lights is not None:
            ul = uniform4(pixel_id, sample_id, b | NEE_BIT, seed & 0xFFFFFFFF)

            def pdf_b_fn(d_l, cos, d_in=d, h=h, is_lam=is_lam, is_glossy=is_glossy):
                pdf_lam = torch.clamp(cos, min=0.0) * (1.0 / math.pi)
                # light below the horizon carries no BRDF (the metal absorbs it)
                pdf_met = lamps.scatter_pdf_metal(d_in, h.normal, h.mat_param, d_l)
                pdf_met = torch.where(cos > 0.0, pdf_met, 0.0)
                return torch.where(is_lam, pdf_lam, torch.where(is_glossy, pdf_met, 0.0))

            direct, traced, lit = lamps.nee_contribution_any(
                hit_fn if shadow_hit_fn is None else shadow_hit_fn, p_hit, h.normal, h.albedo, lights, ul, pdf_b_fn=pdf_b_fn,
                return_masks=True)
            nee_mask = hit_active & (is_lam | is_glossy)
            radiance = radiance + torch.where(nee_mask[..., None], throughput * direct, 0.0)
            count("nee_vertices", nee_mask)
            count("shadow_rays", nee_mask & traced)
            count("shadow_clear", nee_mask & lit)

        throughput = torch.where(hit_active[..., None], throughput * sc.attenuation, throughput)
        rays = rays + active.sum(dtype=torch.int64)
        active = hit_active & ~sc.terminate
        if lights is not None:
            pdf_l = lamps.scatter_pdf_lambertian(h.normal, sc.direction)
            pdf_m = lamps.scatter_pdf_metal(d, h.normal, h.mat_param, sc.direction)
            prev_pdf_b = torch.where(active & is_lam, pdf_l,
                                     torch.where(active & is_glossy, pdf_m, 0.0))
            count("carried_pdfs", active & (is_lam | is_glossy))
        o = torch.where(hit_active[..., None], p_hit, o)
        d = torch.where(hit_active[..., None], sc.direction, d)
    # paths still active after the bounce cap gather no more light (RTIOW)
    return radiance, rays


def render_tile(
    hit_fn: HitFn,
    camera,
    full_width: int,
    full_height: int,
    tile_x0: int,
    tile_y0: int,
    tile_width: int,
    tile_height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset: int = 0,
    lights=None,
    counts: dict | None = None,
    shadow_hit_fn: HitFn | None = None,
    sample_batch: int = 1,
) -> tuple[Tensor, Tensor]:
    """Render a sub-rectangle of a ``full_width x full_height`` image.

    Pixel ids, camera st coords and RNG counters are all functions of
    GLOBAL pixel coordinates. Returns (radiance_sum [th, tw, 3], NOT
    divided by spp, and rays traced as an int64 scalar). ``jitter=False``
    takes every camera ray through the pixel centre (the lens sample
    stays). ``lights``, ``counts`` and ``shadow_hit_fn`` as in
    ``trace_paths``. ``sample_batch`` samples are traced together as one
    batch of rays, and still summed one after another, so the result does
    not depend on it: a larger batch trades memory for fewer launches.
    """
    if sample_batch < 1:
        raise ValueError(f"sample_batch must be at least 1, got {sample_batch}")
    dev = camera.device
    ys = tile_y0 + torch.arange(tile_height, dtype=torch.int64, device=dev)[:, None]
    xs = tile_x0 + torch.arange(tile_width, dtype=torch.int64, device=dev)[None, :]
    pixel_id = ys * full_width + xs  # [th, tw] global ids
    acc = torch.zeros((tile_height, tile_width, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for first in range(0, spp, sample_batch):
        n = min(sample_batch, spp - first)
        s = (torch.arange(first, first + n, dtype=torch.int64, device=dev)
             + int(sample_offset)) & 0xFFFFFFFF
        if n == 1:
            s = int(s[0])
        else:
            s = s[:, None, None]  # [n, 1, 1]: the batch's samples over [th, tw]
        u = uniform4(pixel_id, s, 0xA5A5A5A5, seed)  # pixel jitter + lens sample
        jx, jy = (u[..., 0], u[..., 1]) if jitter else (0.5, 0.5)
        st_x = (xs.to(torch.float32) + jx) / full_width
        st_y = 1.0 - (ys.to(torch.float32) + jy) / full_height
        st_x, st_y = torch.broadcast_to(st_x, u.shape[:-1]), torch.broadcast_to(st_y, u.shape[:-1])
        lens_uv = sample_in_unit_disk(u[..., 2], u[..., 3]) if lens else None
        o, d = camera.rays(st_x, st_y, lens_uv=lens_uv)
        radiance, r = trace_paths(hit_fn, o, d, pixel_id, s, seed, max_bounces, sky=sky,
                                  lights=lights, counts=counts, shadow_hit_fn=shadow_hit_fn)
        for one in (radiance,) if n == 1 else radiance.unbind(0):
            acc = acc + one
        rays = rays + r
    return acc, rays


def slab_rows(height: int, rows: int | None, row_offset: int) -> int:
    """The rows of a full-width slab of a frame ``height`` rows high
    (``rows=None``: the whole frame), checked to lie inside it."""
    rows = height if rows is None else int(rows)
    if rows < 1 or row_offset < 0 or row_offset + rows > height:
        raise ValueError(f"slab rows={rows} at row_offset={row_offset} is not inside a frame "
                         f"of height {height}")
    return rows


def render_image(
    hit_fn: HitFn,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    jitter: bool = True,
    lens: bool = False,
    sample_offset: int = 0,
    lights=None,
    counts: dict | None = None,
    shadow_hit_fn: HitFn | None = None,
    rows: int | None = None,
    row_offset: int = 0,
    sample_batch: int = 1,
) -> tuple[Tensor, Tensor]:
    """Render a linear-radiance image [H, W, 3]; also returns rays traced.

    ``sample_offset`` advances the per-sample RNG counters for progressive
    rendering across frames; ``jitter``, ``lights``, ``counts``,
    ``shadow_hit_fn`` and ``sample_batch`` as in ``render_tile``.
    ``rows``/``row_offset`` render only the full-width slab of rows
    [row_offset, row_offset + rows) of the ``width x height`` frame, as
    [rows, W, 3], and return that slab's rays: the frame's own rows, bit
    for bit, since every counter is a function of global coordinates.
    """
    rows = slab_rows(height, rows, row_offset)
    image_sum, rays = render_tile(
        hit_fn, camera, width, height, 0, row_offset, width, rows,
        spp=spp, max_bounces=max_bounces, seed=seed, sky=sky, jitter=jitter,
        lens=lens, sample_offset=sample_offset, lights=lights, counts=counts,
        shadow_hit_fn=shadow_hit_fn, sample_batch=sample_batch,
    )
    return image_sum / spp, rays


# ---------------------------------------------------------------------------
# Config 1: the milestone-01 frame, faithful to the reference shader
# ---------------------------------------------------------------------------


def render_wololo_frame(time_since_start_sec, width: int, height: int, device=None) -> Tensor:
    """``ep_rt1_1`` of the reference (ubershader1.frag:97-163), quirks kept.

    One animated sphere (y = 2 sin(2 * 3.1415 / 4 * t), z = -11; the
    shader's 3.1415, not pi), normal-map shading 0.5 (n + 1) on a hit, and
    otherwise the ``wololo`` sky (t = y of the normalised direction). The
    directions stay unnormalised through the sphere test, and the normal is
    normalize(d t - center), without the ray origin (right only because
    the origin is 0).
    """
    def scalar(x):  # filled on the device: no host-to-device copy to wait for
        return torch.full((), x, dtype=torch.float32, device=device)

    st_x, st_y = pixel_st_grid(width, height, device=device)
    o, d = WololoCamera.create(device=device).rays(st_x, st_y, aspect_ratio=width / height)
    omega = scalar(2.0 * 3.1415 / 4.0)
    center = torch.stack([scalar(0.0), 2.0 * torch.sin(omega * scalar(time_since_start_sec)),
                          scalar(-1.0 - 10.0)])
    t = intersect.hit_sphere_ref(center, 0.5, o, d)
    n = vec.normalized(d * t[..., None] - center, eps=1e-20)
    return torch.where((t > 0.0)[..., None], 0.5 * (n + 1.0), sky_color(d, "wololo"))


def render_debug_view_1(width: int, height: int, device=None) -> Tensor:
    """``ep_debug_view_1`` (ubershader1.frag:132-137): color = (st.x, st.y, 0)."""
    st_x, st_y = pixel_st_grid(width, height, device=device)
    return torch.stack([st_x, st_y, torch.zeros_like(st_x)], dim=-1)
