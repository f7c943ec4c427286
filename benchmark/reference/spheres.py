"""Plain torch nearest hit over a sphere soup, with exact culling.

Each ray is tested against each sphere by the expanded quadratic (cross
terms d.c and o.c summed left to right, c.c and r^2 per sphere), the
float grouping the renderer's sphere path documents. The nearest root past
t_min wins, and the sphere that owns it shades the hit.

Testing every ray against every sphere of a 487-sphere scene costs tens of
seconds a 1080p/64-spp frame in torch, so small spheres are grouped into
strips along x, each bounded by a box that holds its spheres with a
margin, and a ray tests the spheres of the strips whose box it crosses.
The box test only skips spheres that the ray cannot reach, and the test of
a sphere is the same arithmetic whether or not others were skipped, so the
culled hit equals the uncut one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import Tensor

from .core import T_FAR, Hit, dot, sqrt

EPS = 1e-3  # t_min of every segment
SMALL_FACTOR = 4.0  # spheres up to this times the median radius are culled in strips
BOX_MARGIN = 0.05  # world units around each strip's spheres
RAY_CHUNK = 1 << 21


def quadratic_t(od, oo, a, inv_a, dc, oc, cc, r2):
    half_b = od - dc
    c_term = oo - 2.0 * oc + cc - r2
    disc = half_b * half_b - a * c_term
    sq = sqrt(torch.clamp(disc, min=0.0))
    t0 = (-half_b - sq) * inv_a
    t1 = (-half_b + sq) * inv_a
    t = torch.where(t0 > EPS, t0, t1)
    valid = (disc > 0.0) & (t > EPS) & (t < T_FAR)
    return torch.where(valid, t, torch.full_like(t, T_FAR))


def _pair_dot(v: Tensor, c: Tensor) -> Tensor:
    """dot of rays [N, 3] with centres [S, 3], [N, S], left to right."""
    return v[:, None, 0] * c[None, :, 0] + v[:, None, 1] * c[None, :, 1] \
        + v[:, None, 2] * c[None, :, 2]


@dataclass(frozen=True)
class SphereSoup:
    centers: Tensor  # [S, 3]
    radii: Tensor  # [S] (negative: the normal points inward)
    mat_kind: Tensor  # [S] int
    albedo: Tensor  # [S, 3]
    mat_param: Tensor  # [S]
    groups: tuple  # (sphere ids [G], box lo [3], box hi [3]) per strip; the rest tested always
    always: Tensor  # sphere ids tested by every ray

    @staticmethod
    def build(centers, radii, mat_kind, albedo, mat_param, dtype, device) -> "SphereSoup":
        """From float64 host lists: geometry rounded to float32 once, then
        to ``dtype``."""
        f32 = dict(dtype=torch.float32, device=device)
        c = torch.tensor(centers, **f32)
        r = torch.tensor(radii, **f32)
        radius = [abs(x) for x in radii]
        median = sorted(radius)[len(radius) // 2]
        small = [i for i, x in enumerate(radius) if x <= SMALL_FACTOR * median]
        strips: dict = {}
        for i in small:
            strips.setdefault(math.floor(centers[i][0]), []).append(i)
        groups = []
        for key in sorted(strips):
            ids = strips[key]
            lo = [min(centers[i][k] - radius[i] for i in ids) - BOX_MARGIN for k in range(3)]
            hi = [max(centers[i][k] + radius[i] for i in ids) + BOX_MARGIN for k in range(3)]
            groups.append((torch.tensor(ids, dtype=torch.int64, device=device),
                           torch.tensor(lo, **f32), torch.tensor(hi, **f32)))
        in_strip = set(small)
        always = [i for i in range(len(radii)) if i not in in_strip]
        return SphereSoup(c.to(dtype), r.to(dtype),
                          torch.tensor(mat_kind, dtype=torch.int32, device=device),
                          torch.tensor(albedo, **f32).to(dtype),
                          torch.tensor(mat_param, **f32).to(dtype), tuple(groups),
                          torch.tensor(always, dtype=torch.int64, device=device))

    def _nearest(self, o: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
        """(t, sphere id) of flat rays; t = T_FAR on a miss."""
        od, oo, a = dot(o, d), dot(o, o), dot(d, d)
        inv_a = 1.0 / a
        cc = dot(self.centers, self.centers)
        r2 = self.radii * self.radii

        def test(rays: Tensor | None, ids: Tensor):
            sel = (lambda x: x) if rays is None else (lambda x: x[rays])
            c = self.centers[ids]
            t = quadratic_t(sel(od)[:, None], sel(oo)[:, None], sel(a)[:, None],
                            sel(inv_a)[:, None], _pair_dot(sel(d), c), _pair_dot(sel(o), c),
                            cc[ids], r2[ids])
            j = torch.argmin(t, dim=-1)
            return torch.gather(t, -1, j[:, None])[:, 0], ids[j]

        best_t, best_i = test(None, self.always)
        if self.groups:
            lo = torch.stack([g[1] for g in self.groups]).to(o.dtype)  # [G, 3]
            hi = torch.stack([g[2] for g in self.groups]).to(o.dtype)
            flat = d == 0.0
            inv = 1.0 / torch.where(flat, torch.ones_like(d), d)
            ta = (lo[None] - o[:, None]) * inv[:, None]  # [N, G, 3]
            tb = (hi[None] - o[:, None]) * inv[:, None]
            inside = (o[:, None] >= lo[None]) & (o[:, None] <= hi[None])
            near = torch.where(flat[:, None], torch.where(inside, -T_FAR, T_FAR),
                               torch.minimum(ta, tb)).amax(dim=-1)
            far = torch.where(flat[:, None], torch.where(inside, T_FAR, -T_FAR),
                              torch.maximum(ta, tb)).amin(dim=-1)
            crosses = (far >= near) & (far > 0.0)  # [N, G]
            for g, (ids, _, _) in enumerate(self.groups):
                rays = torch.nonzero(crosses[:, g])[:, 0]
                if rays.numel() == 0:
                    continue
                t, i = test(rays, ids)
                better = (t < best_t[rays]) | ((t == best_t[rays]) & (i < best_i[rays]))
                best_t[rays] = torch.where(better, t, best_t[rays])
                best_i[rays] = torch.where(better, i, best_i[rays])
        return best_t, best_i

    def nearest_hit(self, o: Tensor, d: Tensor) -> Hit:
        batch = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [self._nearest(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                 for s in range(0, o.shape[0], RAY_CHUNK)]
        t = torch.cat([p[0] for p in parts])
        idx = torch.cat([p[1] for p in parts])
        hit = t < T_FAR
        t_safe = torch.where(hit, t, torch.ones_like(t))
        p = o + t_safe[:, None] * d
        outward = (p - self.centers[idx]) / self.radii[idx][:, None]
        front = dot(d, outward) < 0.0
        n = torch.where(front[:, None], outward, -outward)
        h = Hit(t, hit, n, front, self.mat_kind[idx], self.albedo[idx], self.mat_param[idx])
        return Hit(*(x.reshape(batch + x.shape[1:]) for x in h))
