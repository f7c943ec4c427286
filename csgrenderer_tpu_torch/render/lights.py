"""Next-event estimation (direct light sampling) toward emissive lamps.

Twin of ``csgrenderer_tpu/render/lights.py``. Plain path tracing finds a
small lamp under a black sky only by chance; NEE samples the lamps
directly:

- at every Lambertian (or glossy-metal) hit, pick one lamp uniformly and
  sample a direction in the cone its sphere subtends
  (pdf = 1 / (2 pi (1 - cos_theta_max)));
- trace a shadow ray; the lamp is visible iff the scene's nearest hit is
  not closer than the analytic hit on the sampled lamp, by a relative
  1e-4 (an identity-free test: no hit ids needed);
- add albedo * L_e * q / (1 + q), q = pdf_bsdf * L * (2 pi (1 - cos_max)):
  the balance-heuristic MIS weight against the vertex's BSDF strategy,
  folded into one closed form (``nee_contribution``);
- lamp emission found by a pairable BSDF sample keeps the partner weight
  q / (q + 1) (``bsdf_mis_scale``), so the two strategies sum to one
  estimator; camera rays and specular chains keep full emission.

The triangle-lamp half (``TriLights``, area sampling) is the same
estimator for emissive mesh faces; no kernel of this package uses it yet.
Square roots go through ``vec.sqrt`` (correctly rounded on every device),
so the CPU results agree with XLA's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..math import vec
from ..scene.graph import NodeType

BIG = 1e30  # sphere_ray_t's miss
MISS_CUT = 1e29  # a lamp distance at or past this is a miss
SHADOW_SCALE = 1.0 - 1e-4  # occluded iff the nearest hit is below tl * this
OUTSIDE_SCALE = 1.0 + 1e-6  # p is outside a lamp iff dist^2 > r^2 * this


class SphereLights(NamedTuple):
    """Struct-of-arrays emissive-sphere list."""

    centers: Tensor  # [L, 3]
    radii: Tensor  # [L] (positive)
    emit: Tensor  # [L, 3] radiance

    @property
    def num_lights(self) -> int:
        return self.centers.shape[0]


class TriLights(NamedTuple):
    """Struct-of-arrays emissive-triangle list. ``normal`` (unit
    cross(e1, e2)) and ``area`` (|cross| / 2) are precomputed. Lamps are
    double-sided (|cos| in the pdf)."""

    v0: Tensor  # [L, 3]
    e1: Tensor  # [L, 3]
    e2: Tensor  # [L, 3]
    emit: Tensor  # [L, 3] radiance
    normal: Tensor  # [L, 3] unit geometric normal
    area: Tensor  # [L]

    @property
    def num_lights(self) -> int:
        return self.v0.shape[0]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def _device(x):
    return x.device if isinstance(x, Tensor) else None


def _tensor(a: np.ndarray, device) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def extract_lights(scene, return_ids: bool = False):
    """Emissive spheres of a SphereScene, or None if it has none.

    ``return_ids=True`` also returns the lamps' sphere indices (numpy
    int64) in ``scene``'s ordering: the kernels' id space. The tensors
    live on the scene's device.
    """
    ids = np.where(_host(scene.mat_kind) == 4)[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    dev = scene.centers.device
    sel = torch.from_numpy(ids).to(dev)
    lights = SphereLights(
        centers=scene.centers[sel].to(torch.float32),
        radii=torch.abs(scene.radii[sel].to(torch.float32)),
        emit=scene.albedo[sel].to(torch.float32),
    )
    return (lights, ids) if return_ids else lights


def extract_tape_lights(tape, return_ids: bool = False):
    """Emissive SPHERE leaves of a CompiledTape as SphereLights, or None.

    Lamp centres are the leaves' baked world positions (``leaf_pos``),
    radii their sphere parameter. A lamp whose sphere is cut by boolean
    operations still samples the full sphere; the shadow test against the
    real CSG surface keeps the estimator consistent. ``return_ids``: also
    return the lamp leaf indices (static under animation: the tape kernel
    reads the lamps' scalars from its leaf table, so moved lamps need no
    new extraction).
    """
    kinds = _host(tape.mat_kind)
    types = np.asarray(tape.leaf_types)
    ids = np.where((kinds == 4) & (types == int(NodeType.SPHERE)))[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    sel = torch.from_numpy(ids).to(tape.leaf_pos.device)
    lights = SphereLights(
        centers=tape.leaf_pos[sel],
        radii=torch.abs(tape.leaf_params[sel, 0]),
        emit=tape.albedo[sel],
    )
    return (lights, ids) if return_ids else lights


def sample_sphere_cone(p: Tensor, c: Tensor, r, u1: Tensor, u2: Tensor):
    """A direction from ``p`` toward sphere (c, r), uniform in its cone.

    Returns (unit direction [..., 3], inv_pdf [...]) with
    inv_pdf = 2 pi (1 - cos_theta_max), and 0 where p is inside the
    sphere (no valid cone: callers drop the sample).
    """
    to_c = c - p
    dist2 = vec.dot(to_c, to_c)
    r2 = r * r
    outside = dist2 > r2 * OUTSIDE_SCALE
    cos_max = vec.sqrt(torch.clamp(1.0 - r2 / torch.clamp(dist2, min=1e-20), min=0.0))
    z = 1.0 + u2 * (cos_max - 1.0)  # cos(theta) uniform in [cos_max, 1]
    phi = (2.0 * math.pi) * u1
    sin_t = vec.sqrt(torch.clamp(1.0 - z * z, min=0.0))

    w = vec.normalized(to_c, eps=1e-20)
    # orthonormal basis around w (branchless, Frisvad-style sign trick)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    sign = torch.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    t0 = torch.stack([1.0 + sign * wx * wx * a, sign * b, -sign * wx], dim=-1)
    t1 = torch.stack([b, sign + wy * wy * a, -wy], dim=-1)

    d = (torch.cos(phi) * sin_t)[..., None] * t0 + (torch.sin(phi) * sin_t)[..., None] * t1 \
        + z[..., None] * w
    inv_pdf = torch.where(outside, (2.0 * math.pi) * (1.0 - cos_max), 0.0)
    return d, inv_pdf


def sphere_ray_t(p: Tensor, d: Tensor, c: Tensor, r, eps: float = 1e-3) -> Tensor:
    """Nearest intersection t > eps of a UNIT-direction ray with sphere
    (c, r); BIG (1e30) on a miss. The shadow test's target distance."""
    oc = p - c
    half_b = vec.dot(oc, d)
    cc = vec.dot(oc, oc) - r * r
    disc = half_b * half_b - cc
    sq = vec.sqrt(disc)  # NaN on a miss: every comparison below rejects it
    t0 = -half_b - sq
    t1 = -half_b + sq
    t = torch.where(t0 > eps, t0, t1)
    return torch.where(t > eps, t, BIG)


def nee_contribution(hit_fn, p, n, albedo, lights: SphereLights, u, pdf_b_fn=None,
                     return_masks: bool = False):
    """MIS-weighted direct light at scattering hit points.

    ``u``: [..., >= 3] uniforms (lamp pick, cone u1, cone u2). Returns
    [..., 3] radiance, already BRDF-, pdf- and MIS-weighted (multiply by
    the path throughput and the caller's material mask).

    With pdf_L = 1 / (L * ip), ip = 2 pi (1 - cos_max), and the vertex
    BSDF's pdf_b (``pdf_b_fn(d, cos)``; default the cosine lobe cos / pi),
    the procedural BRDF is albedo * pdf_b, so the balance-heuristic
    contribution folds to albedo * L_e * q / (1 + q), q = pdf_b * L * ip.

    ``return_masks``: also return the mask of samples whose shadow ray
    must be traced (a usable lamp sample; the kernels skip the others) and
    the mask of those that reach the lamp unoccluded.
    """
    nl = lights.num_lights
    li = torch.clamp((u[..., 0] * nl).to(torch.int32), max=nl - 1).to(torch.int64)
    c = lights.centers[li]
    r = lights.radii[li]
    e = lights.emit[li]

    d, inv_pdf = sample_sphere_cone(p, c, r, u[..., 1], u[..., 2])
    cos = vec.dot(n, d)
    if pdf_b_fn is None:
        pdf_b = torch.clamp(cos, min=0.0) * (1.0 / math.pi)
    else:
        pdf_b = pdf_b_fn(d, cos)
    t_light = sphere_ray_t(p, d, c, r)
    traced = (pdf_b > 0.0) & (inv_pdf > 0.0) & (t_light < MISS_CUT)
    sh = hit_fn(p, d)
    occluded = sh.hit & (sh.t < t_light * SHADOW_SCALE)
    lit = traced & ~occluded
    q = pdf_b * nl * inv_pdf
    scale = torch.where(lit, q / (1.0 + q), 0.0)
    direct = albedo * e * scale[..., None]
    return (direct, traced, lit) if return_masks else direct


def scatter_pdf_lambertian(n: Tensor, d_new: Tensor) -> Tensor:
    """Solid-angle pdf of the cosine-weighted Lambertian scatter: cos / pi
    of the normalized new direction (the carried MIS pdf)."""
    ud = vec.normalized(d_new, eps=1e-20)
    return torch.clamp(vec.dot(n, ud), min=0.0) * (1.0 / math.pi)


def scatter_pdf_metal(d_in, n, fuzz, d_new):
    """Solid-angle pdf of the RTIOW fuzzy-metal scatter.

    The material scatters d_new = reflect(unit(d_in), n) + fuzz * u with u
    uniform on the unit sphere. For a unit query direction w with
    c = w . r (r the mirror direction), g = sqrt(c^2 - 1 + f^2) and
    t+- = c +- g,
        pdf(w) = (t+^2 [t+ > 0] + t-^2 [t- > 0]) / (4 pi f g),
    0 outside the cone (g^2 <= 0) and for mirror metal (f <= 1e-4: a
    delta, returned as "not pairable").
    """
    ud = vec.normalized(d_in, eps=1e-20)
    r = ud - 2.0 * vec.dot(ud, n)[..., None] * n
    w = vec.normalized(d_new, eps=1e-20)
    c = vec.dot(w, r)
    f = torch.as_tensor(fuzz, dtype=torch.float32, device=c.device)
    f_ok = f > 1e-4
    f_safe = torch.clamp(f, min=1e-4)
    g2 = c * c - 1.0 + f_safe * f_safe
    g = vec.sqrt(torch.clamp(g2, min=1e-20))
    tp = c + g
    tm = c - g
    num = torch.where(tp > 0.0, tp * tp, 0.0) + torch.where(tm > 0.0, tm * tm, 0.0)
    pdf = num / ((4.0 * math.pi) * f_safe * g)
    return torch.where(f_ok & (g2 > 0.0), pdf, 0.0)


def _cone_partner(c, r, o_prev, prev_pdf_b, nl: int) -> Tensor:
    """w_B = q / (q + 1), q = prev_pdf_b * L * ip, ip the cone inv-pdf of
    lamp (c, r) from ``o_prev`` (BIG inside the lamp: w_B -> 1)."""
    to_c = c - o_prev
    dist2 = vec.dot(to_c, to_c)
    r2 = r * r
    outside = dist2 > r2 * OUTSIDE_SCALE
    cos_max = vec.sqrt(torch.clamp(1.0 - r2 / torch.clamp(dist2, min=1e-20), min=0.0))
    ip = torch.where(outside, (2.0 * math.pi) * (1.0 - cos_max), BIG)
    q = prev_pdf_b * nl * ip
    return q / (q + 1.0)


def bsdf_mis_scale(lights: SphereLights, o_prev, p_hit, prev_pdf_b):
    """MIS weight for lamp emission found BY the BSDF sample.

    ``o_prev``: the previous vertex (the ray origin); ``p_hit``: the
    emissive hit point; ``prev_pdf_b``: the carried pdf of the scatter
    that made this ray (callers pass emission unweighted where it is 0).
    The lamp holding ``p_hit`` is the argmin of |dist(p, c_l) - r_l| over
    the lamp table (first minimum).
    """
    dvec = p_hit[..., None, :] - lights.centers  # [..., L, 3]
    dist = vec.sqrt(vec.dot(dvec, dvec))  # [..., L]
    li = torch.argmin(torch.abs(dist - lights.radii), dim=-1)
    return _cone_partner(lights.centers[li], lights.radii[li], o_prev, prev_pdf_b,
                         lights.num_lights)


def extract_mesh_lights(mesh, return_ids: bool = False):
    """Emissive faces of a triangle mesh (fields ``v0``, ``e1``, ``e2``,
    ``mat_kind``, ``albedo``) as TriLights, or None if it has none.
    ``return_ids``: also return the lamp faces' indices."""
    ids = np.where(_host(mesh.mat_kind) == 4)[0]
    if ids.size == 0:
        return (None, ids) if return_ids else None
    dev = _device(mesh.v0)
    e1 = _host(mesh.e1).astype(np.float32)[ids]
    e2 = _host(mesh.e2).astype(np.float32)[ids]
    cr = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    twoa = np.sqrt((cr * cr).sum(axis=-1))
    lights = TriLights(
        v0=_tensor(_host(mesh.v0)[ids], dev),
        e1=_tensor(e1, dev),
        e2=_tensor(e2, dev),
        emit=_tensor(_host(mesh.albedo)[ids], dev),
        normal=_tensor(cr / np.maximum(twoa, 1e-30)[:, None], dev),
        area=_tensor(0.5 * twoa, dev),
    )
    return (lights, ids) if return_ids else lights


def sample_triangle(v0, e1, e2, u1, u2):
    """Uniform area sample of the triangle (v0, v0+e1, v0+e2):
    r = sqrt(u1), barycentrics (1 - r, u2 r). Returns [..., 3] points."""
    r = vec.sqrt(u1)
    bu = (1.0 - r)[..., None]
    bv = (u2 * r)[..., None]
    return v0 + bu * e1 + bv * e2


def nee_contribution_tri(hit_fn, p, n, albedo, lights: TriLights, u, pdf_b_fn=None,
                         return_masks: bool = False):
    """MIS-weighted direct light from triangle lamps (area sampling).

    pdf_L = dist^2 / (|cos_l| A L) at the sampled direction, so the folded
    contribution is albedo * L_e * q / (1 + q), q = pdf_b / pdf_L. The
    sampled point lies ON the lamp face, so the 1e-4 relative shadow
    window keeps the lamp's own hit from occluding. ``return_masks`` as in
    ``nee_contribution``.
    """
    nl = lights.num_lights
    li = torch.clamp((u[..., 0] * nl).to(torch.int32), max=nl - 1).to(torch.int64)
    e = lights.emit[li]
    n_l = lights.normal[li]
    area = lights.area[li]

    q_pt = sample_triangle(lights.v0[li], lights.e1[li], lights.e2[li], u[..., 1], u[..., 2])
    to = q_pt - p
    dist2 = vec.dot(to, to)
    t_l = vec.sqrt(torch.clamp(dist2, min=1e-20))
    d = to / t_l[..., None]
    cos_v = vec.dot(n, d)
    if pdf_b_fn is None:
        pdf_b = torch.clamp(cos_v, min=0.0) * (1.0 / math.pi)
    else:
        pdf_b = pdf_b_fn(d, cos_v)
    cos_l = torch.abs(vec.dot(n_l, d))
    traced = (pdf_b > 0.0) & (cos_l > 1e-6) & (dist2 > 1e-12)
    sh = hit_fn(p, d)
    occluded = sh.hit & (sh.t < t_l * SHADOW_SCALE)
    lit = traced & ~occluded
    q = pdf_b * nl * area * cos_l / torch.clamp(dist2, min=1e-20)
    scale = torch.where(lit, q / (1.0 + q), 0.0)
    direct = albedo * e * scale[..., None]
    return (direct, traced, lit) if return_masks else direct


def bsdf_mis_scale_tri(lights: TriLights, o_prev, p_hit, prev_pdf_b):
    """MIS weight for triangle-lamp emission found BY the BSDF sample: the
    lamp holding ``p_hit`` is the argmin of |signed plane distance|, and
    w_B = q / (q + 1), q = prev_pdf_b * L * A * |cos_l| / dist^2."""
    dvec = p_hit[..., None, :] - lights.v0  # [..., L, 3]
    li = torch.argmin(torch.abs(vec.dot(dvec, lights.normal)), dim=-1)
    n_l = lights.normal[li]
    area = lights.area[li]
    to = p_hit - o_prev
    dist2 = vec.dot(to, to)
    t_l = vec.sqrt(torch.clamp(dist2, min=1e-20))
    d = to / t_l[..., None]
    cos_l = torch.abs(vec.dot(n_l, d))
    q = prev_pdf_b * lights.num_lights * area * cos_l / torch.clamp(dist2, min=1e-20)
    return q / (q + 1.0)


def nee_contribution_any(hit_fn, p, n, albedo, lights, u, pdf_b_fn=None,
                         return_masks: bool = False):
    """Dispatch on the lamp type: SphereLights -> cone, TriLights -> area."""
    fn = nee_contribution_tri if isinstance(lights, TriLights) else nee_contribution
    return fn(hit_fn, p, n, albedo, lights, u, pdf_b_fn=pdf_b_fn, return_masks=return_masks)


def bsdf_mis_scale_any(lights, o_prev, p_hit, prev_pdf_b):
    """Dispatch twin of ``nee_contribution_any``."""
    if isinstance(lights, TriLights):
        return bsdf_mis_scale_tri(lights, o_prev, p_hit, prev_pdf_b)
    return bsdf_mis_scale(lights, o_prev, p_hit, prev_pdf_b)
