"""Ray-primitive intersection, in two forms.

Twin of ``csgrenderer_tpu/render/intersect.py``:

1. nearest hit over a sphere soup (``spheres_nearest_hit``), the RTIOW
   path;
2. the interval form (``*_interval``): each convex CSG primitive maps a
   ray, in the primitive's LOCAL frame, to one (t_enter, t_exit) slab of
   "inside" parameter values along the full line (empty when t_enter >
   t_exit), plus the local outward normals. These feed the interval-list
   algebra (``render/interval.py``).

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
T_NEG = -1e9


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
    sqrt_disc = vec.sqrt(torch.clamp(disc, min=0.0))
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


# ---------------------------------------------------------------------------
# Interval (slab) form, local frame: feeds CSG boolean combination
# ---------------------------------------------------------------------------


def sphere_interval(o: Tensor, d: Tensor, radius) -> tuple[Tensor, Tensor]:
    """(enter, exit) of |p| <= r along o + t d; enter > exit when missed."""
    a = vec.dot(d, d)
    half_b = vec.dot(o, d)
    c = vec.dot(o, o) - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    return torch.where(ok, (-half_b - sq) * inv_a, T_FAR), torch.where(ok, (-half_b + sq) * inv_a, T_NEG)


def halfspace_interval(o: Tensor, d: Tensor, normal: Tensor) -> tuple[Tensor, Tensor]:
    """Solid = {p : p . n <= 0} (outward-facing normal, plane through origin).

    ``t0`` is +-inf or NaN where the ray is parallel (dn == 0); the
    ``parallel`` selects replace it, so no arithmetic touches it.
    """
    dn = vec.dot(d, normal)
    on = vec.dot(o, normal)
    t0 = -on / dn
    entering = dn < 0.0
    parallel = dn == 0.0
    inside_all = parallel & (on <= 0.0)
    enter = torch.where(entering, t0, T_NEG)
    exit_ = torch.where(entering, T_FAR, t0)
    enter = torch.where(parallel, torch.where(inside_all, T_NEG, T_FAR), enter)
    exit_ = torch.where(parallel, torch.where(inside_all, T_FAR, T_NEG), exit_)
    return enter, exit_


def box_interval(o: Tensor, d: Tensor, half_extents: Tensor) -> tuple[Tensor, Tensor]:
    """Axis-aligned box |p_i| <= he_i by the slab method, branch-free.

    A degenerate axis (d_i == 0) gives (T_NEG, T_FAR) when the origin is
    inside that slab and an empty slab otherwise: no inf * 0.
    """
    flat = d == 0.0
    inv_d = 1.0 / torch.where(flat, torch.ones_like(d), d)
    ta = (-half_extents - o) * inv_d
    tb = (half_extents - o) * inv_d
    t_lo = torch.minimum(ta, tb)
    t_hi = torch.maximum(ta, tb)
    inside_slab = torch.abs(o) <= half_extents
    t_lo = torch.where(flat, torch.where(inside_slab, T_NEG, T_FAR), t_lo)
    t_hi = torch.where(flat, torch.where(inside_slab, T_FAR, T_NEG), t_hi)
    enter = torch.maximum(torch.maximum(t_lo[..., 0], t_lo[..., 1]), t_lo[..., 2])
    exit_ = torch.minimum(torch.minimum(t_hi[..., 0], t_hi[..., 1]), t_hi[..., 2])
    return enter, exit_


def cylinder_interval(o: Tensor, d: Tensor, radius, half_height) -> tuple[Tensor, Tensor]:
    """Capped cylinder around local +y: x^2 + z^2 <= r^2, |y| <= h."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx + dz * dz
    half_b = ox * dx + oz * dz
    c = ox * ox + oz * oz - radius * radius
    disc = half_b * half_b - a * c
    ok = disc >= 0.0
    sq = vec.sqrt(torch.clamp(disc, min=0.0))
    degenerate = a == 0.0  # ray parallel to the axis
    inv_a = 1.0 / torch.where(degenerate, torch.ones_like(a), a)
    side_enter = torch.where(ok, (-half_b - sq) * inv_a, T_FAR)
    side_exit = torch.where(ok, (-half_b + sq) * inv_a, T_NEG)
    inside_tube = c <= 0.0
    side_enter = torch.where(degenerate, torch.where(inside_tube, T_NEG, T_FAR), side_enter)
    side_exit = torch.where(degenerate, torch.where(inside_tube, T_FAR, T_NEG), side_exit)
    # y slab
    flat_y = dy == 0.0
    safe_dy = torch.where(flat_y, torch.ones_like(dy), dy)
    ty_a = (-half_height - oy) / safe_dy
    ty_b = (half_height - oy) / safe_dy
    cap_lo = torch.minimum(ty_a, ty_b)
    cap_hi = torch.maximum(ty_a, ty_b)
    inside_y = torch.abs(oy) <= half_height
    cap_lo = torch.where(flat_y, torch.where(inside_y, T_NEG, T_FAR), cap_lo)
    cap_hi = torch.where(flat_y, torch.where(inside_y, T_FAR, T_NEG), cap_hi)
    return torch.maximum(side_enter, cap_lo), torch.minimum(side_exit, cap_hi)


# ---------------------------------------------------------------------------
# Local-frame outward normals (at hit point p, local coordinates)
# ---------------------------------------------------------------------------


def sphere_normal(p: Tensor, radius: Tensor) -> Tensor:
    return p / torch.clamp(radius, min=1e-12)[..., None]


def halfspace_normal(p: Tensor, normal: Tensor) -> Tensor:
    return torch.broadcast_to(normal, p.shape)


def box_normal(p: Tensor, half_extents: Tensor) -> Tensor:
    """Outward normal = the axis where |p|/he is largest, signed by p."""
    q = torch.abs(p) / torch.clamp(half_extents, min=1e-12)
    axis = torch.argmax(q, dim=-1)  # first maximum, as jnp.argmax
    onehot = torch.nn.functional.one_hot(axis, 3).to(p.dtype)
    return onehot * torch.sign(p)


def cylinder_normal(p: Tensor, radius: Tensor, half_height) -> Tensor:
    """Side normal (x, 0, z)/r or cap normal (0, +-1, 0), by the nearer face."""
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    side_gap = torch.abs(vec.sqrt(px * px + pz * pz) - radius)
    cap_gap = torch.abs(torch.abs(py) - half_height)
    zero = torch.zeros_like(px)
    side_n = torch.stack([px, zero, pz], dim=-1) / torch.clamp(radius, min=1e-12)[..., None]
    cap_n = torch.stack([zero, torch.sign(py), zero], dim=-1)
    return torch.where((side_gap < cap_gap)[..., None], side_n, cap_n)
