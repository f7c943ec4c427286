"""RTIOW materials with branch-free dispatch.

Twin of ``csgrenderer_tpu/render/materials.py``: normal-map (kind 0),
Lambertian (1), metal (2), dielectric (3), emissive (4). Every material's
scatter is computed for every ray and the result is selected by kind.

Convention: ``n`` is the unit shading normal ALREADY face-forwarded to
oppose the incoming ray; ``front_face`` says whether the ray hits the
solid from outside (it picks the dielectric's eta ratio).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..math import vec
from .sampling import sample_unit_vector

KIND_NORMAL_MAP = 0
KIND_LAMBERTIAN = 1
KIND_METAL = 2
KIND_DIELECTRIC = 3
KIND_EMISSIVE = 4


class Scatter(NamedTuple):
    direction: Tensor  # [..., 3] next ray direction (unnormalised ok)
    attenuation: Tensor  # [..., 3] throughput multiplier
    emitted: Tensor  # [..., 3] radiance added at this vertex
    terminate: Tensor  # [...] bool: the path ends here


def scatter(
    mat_kind: Tensor,  # [...] int
    albedo: Tensor,  # [..., 3]
    mat_param: Tensor,  # [...] f32 (metal fuzz | dielectric IOR)
    d_in: Tensor,  # [..., 3] incoming direction (need not be unit)
    n: Tensor,  # [..., 3] unit normal opposing d_in
    front_face: Tensor,  # [...] bool
    u: Tensor,  # [..., 4] uniforms in [0,1)
) -> Scatter:
    unit_d = vec.normalized(d_in, eps=1e-20)
    rand_unit = sample_unit_vector(u[..., 0], u[..., 1])

    # Lambertian: n + random unit vector (cosine-weighted); degenerate -> n.
    lam_dir = n + rand_unit
    lam_degenerate = vec.lengthsqr(lam_dir) < 1e-12
    lam_dir = torch.where(lam_degenerate[..., None], n, lam_dir)

    # Metal: mirror + fuzz * random unit; absorbed if it dives below surface.
    refl = vec.reflect(unit_d, n)
    metal_dir = refl + mat_param[..., None] * rand_unit
    metal_absorbed = vec.dot(metal_dir, n) <= 0.0

    # Dielectric: Snell + Schlick, reflect when it cannot refract.
    ir = torch.clamp(mat_param, min=1e-6)
    eta = torch.where(front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(vec.dot(-unit_d, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta * sin_theta > 1.0
    q = (1.0 - eta) / (1.0 + eta)
    r0 = q * q
    c1 = 1.0 - cos_theta
    c2 = c1 * c1
    reflect_prob = r0 + (1.0 - r0) * (c2 * c2 * c1)  # Schlick: (1 - cos)^5
    use_reflect = cannot_refract | (u[..., 2] < reflect_prob)
    refracted = vec.refract(unit_d, n, eta)
    diel_dir = torch.where(use_reflect[..., None], refl, refracted)

    is_lam = mat_kind == KIND_LAMBERTIAN
    is_metal = mat_kind == KIND_METAL
    is_diel = mat_kind == KIND_DIELECTRIC
    is_emissive = mat_kind == KIND_EMISSIVE
    is_normal_map = mat_kind == KIND_NORMAL_MAP

    direction = torch.where(
        is_lam[..., None], lam_dir, torch.where(is_metal[..., None], metal_dir, diel_dir)
    )
    attenuation = torch.where(is_diel[..., None], torch.ones_like(albedo), albedo)
    # normal-map "material" terminates with the reference's debug shading
    # 0.5 * (n + 1); emissive terminates with its own colour
    emitted = torch.where(
        is_normal_map[..., None],
        0.5 * (n + 1.0),
        torch.where(is_emissive[..., None], albedo, torch.zeros_like(albedo)),
    )
    terminate = is_normal_map | is_emissive | (is_metal & metal_absorbed)
    return Scatter(direction, attenuation, emitted, terminate)
