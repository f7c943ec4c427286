"""Ray-sphere intersection.

Twin of ``csgrenderer_tpu/render/intersect.py`` (sphere part). The CSG
interval forms wait for the CSG port (ROADMAP A5).

``spheres_nearest_hit`` keeps the reference's expanded quadratic (cross
terms d.c and o.c over an [N, S] grid, then one min/argmin). The cross
terms are elementwise products summed in a fixed order, not a matmul, so
no TF32 matmul mode touches them and the CUDA kernel can repeat them.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..math import vec

T_FAR = 1e9  # finite stand-in for +inf


def hit_sphere_ref(center: Tensor, radius, o: Tensor, d: Tensor) -> Tensor:
    """Exact reference semantics (``ubershader1.frag:84-95``): near root or -1.

    The reference neither normalises d nor clips t > 0 here; callers test
    ``t > 0`` themselves.
    """
    oc = o - center
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(oc * d, dim=-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=o.device)
    c = torch.sum(oc * oc, dim=-1) - r * r
    disc = b * b - 4.0 * a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    return torch.where(disc < 0.0, torch.full_like(t, -1.0), t)


def quadratic_t(od, oo, a, inv_a, dc, oc, cc, r2, t_min: float, t_max: float, miss: float):
    """Nearest root past t_min of the expanded ray-sphere quadratic.

    Per ray: od = o.d, oo = o.o, a = d.d, inv_a = 1/a; per (ray, sphere):
    dc = d.c, oc = o.c; per sphere: cc = c.c, r2 = r^2. This is the
    reference's float grouping (``csgrenderer_tpu`` ``spheres_nearest_hit``),
    shared by the brute pass, the grid walk and, operation for operation,
    the CUDA kernel. The explicit ``disc > 0`` test keeps a miss (or a pad)
    a miss under any math mode. Returns t, or ``miss``.
    """
    half_b = od - dc  # (o - c) . d
    c_term = oo - 2.0 * oc + cc - r2
    disc = half_b * half_b - a * c_term
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-half_b - sqrt_disc) * inv_a
    t1 = (-half_b + sqrt_disc) * inv_a
    t = torch.where(t0 > t_min, t0, t1)
    valid = (disc > 0.0) & (t > t_min) & (t < t_max)
    return torch.where(valid, t, torch.full_like(t, miss))


def ray_terms(o: Tensor, d: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-ray (o.d, o.o, d.d, 1/d.d) of rays [N,3], each as [N, 1]."""
    od = vec.dot(o, d)[:, None]
    oo = vec.dot(o, o)[:, None]
    a = vec.dot(d, d)[:, None]
    return od, oo, a, 1.0 / a


def spheres_nearest_hit(
    o: Tensor,
    d: Tensor,
    centers: Tensor,
    radii: Tensor,
    t_min: float,
    t_max: float = T_FAR,
) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest hit of rays [N,3] against spheres [S,3]/[S].

    Returns (t [N], idx [N] int64, hit [N] bool); a miss has t = T_FAR.
    On equal t the lowest sphere index wins.
    """
    od, oo, a, inv_a = ray_terms(o, d)
    c = centers[None]  # [1, S, 3]
    dc = vec.dot(d[:, None, :], c)  # [N, S]
    oc = vec.dot(o[:, None, :], c)  # [N, S]
    cc = vec.dot(centers, centers)  # [S]
    t = quadratic_t(od, oo, a, inv_a, dc, oc, cc, radii * radii, t_min, t_max, T_FAR)
    idx = torch.argmin(t, dim=-1)  # first minimum: lowest index on ties
    t_near = torch.gather(t, -1, idx[:, None])[:, 0]
    return t_near, idx, t_near < T_FAR
