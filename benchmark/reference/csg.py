"""Plain torch nearest hit of a CSG tree of sphere leaves, by event flip.

A leaf is a sphere of radius r in its own frame; a ray maps into that
frame by the leaf's world-to-local quaternion and origin. Along a ray each
leaf is inside over one interval [enter, exit]. The tree's surface is the
smallest leaf boundary t past t_min where the root's membership just below
and just above t differ; membership at a t is the postfix program folded
over the leaves' memberships there. The hit's normal is that of the leaf
whose surface lies nearest the hit point, face-forwarded against the ray,
and its ``front_face`` says whether the ray enters the solid.

``deep_chain`` builds the leaves of a chain of unions and differences whose
edges rotate about y, as the configuration file states them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .core import T_FAR, T_NEG, Hit, dot, quat_conjugate, quat_multiply, quat_rotate, sqrt

EPS = 1e-3
SURFACE_CUTOFF = 5e8
PUSH, UNION, INTERSECT, DIFF = 0, 1, 2, 3
RAY_CHUNK = 1 << 20


def _fold(ops, mem: Tensor) -> Tensor:
    stack = []
    for opcode, leaf in ops:
        if opcode == PUSH:
            stack.append(mem[..., leaf])
            continue
        right, left = stack.pop(), stack.pop()
        stack.append(left | right if opcode == UNION else
                     left & right if opcode == INTERSECT else left & ~right)
    return stack[0]


@dataclass(frozen=True)
class SphereTree:
    ops: tuple  # postfix ((opcode, leaf), ...)
    leaf_rot: Tensor  # [L, 4] world -> local
    leaf_pos: Tensor  # [L, 3] leaf origin, world
    radius: Tensor  # [L]
    mat_kind: Tensor  # [L] int
    albedo: Tensor  # [L, 3]
    mat_param: Tensor  # [L]

    def _intervals(self, o: Tensor, d: Tensor):
        lo = quat_rotate(self.leaf_rot, o[:, None, :] - self.leaf_pos)  # [N, L, 3]
        ld = quat_rotate(self.leaf_rot, d[:, None, :])
        a = dot(ld, ld)
        half_b = dot(lo, ld)
        c = dot(lo, lo) - self.radius * self.radius
        disc = half_b * half_b - a * c
        ok = disc >= 0.0
        sq = sqrt(torch.clamp(disc, min=0.0))
        inv_a = 1.0 / a
        return (torch.where(ok, (-half_b - sq) * inv_a, T_FAR),
                torch.where(ok, (-half_b + sq) * inv_a, T_NEG))

    def _surface(self, o: Tensor, d: Tensor):
        e, x = self._intervals(o, d)
        n = o.shape[0]
        cands = torch.stack([e, x], dim=-1).reshape(n, -1)  # leaf by leaf, enter first
        tj = cands[:, :, None]
        below = _fold(self.ops, (e[:, None, :] < tj) & (x[:, None, :] >= tj))
        above = _fold(self.ops, (e[:, None, :] <= tj) & (x[:, None, :] > tj))
        tj = tj[..., 0]
        flip = (below != above) & (tj > EPS) & (tj < SURFACE_CUTOFF)
        cand = torch.where(flip, tj, torch.full_like(tj, T_FAR))
        first = torch.argmin(cand, dim=-1, keepdim=True)
        return torch.gather(cand, -1, first)[:, 0], torch.gather(above, -1, first)[:, 0]

    def nearest_hit(self, o: Tensor, d: Tensor) -> Hit:
        batch = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [self._surface(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                 for s in range(0, o.shape[0], RAY_CHUNK)]
        t = torch.cat([p[0] for p in parts])
        entering = torch.cat([p[1] for p in parts])
        hit = t < SURFACE_CUTOFF
        t_safe = torch.where(hit, t, torch.ones_like(t))
        p = o + t_safe[:, None] * d
        loc = quat_rotate(self.leaf_rot, p[:, None, :] - self.leaf_pos)
        rad = sqrt(dot(loc, loc))
        owner = torch.argmin(torch.abs(rad - self.radius), dim=-1)
        nl = loc * (1.0 / torch.clamp(rad, min=1e-12))[..., None]
        nl = torch.gather(nl, 1, owner[:, None, None].expand(-1, 1, 3))[:, 0]
        nw = quat_rotate(quat_conjugate(self.leaf_rot[owner]), nl)
        sgn = torch.where(dot(d, nw) > 0.0, -1.0, 1.0).to(nw.dtype)
        h = Hit(t, hit, nw * sgn[:, None], entering, self.mat_kind[owner], self.albedo[owner],
                self.mat_param[owner])
        return Hit(*(v.reshape(batch + v.shape[1:]) for v in h))


def deep_chain(levels: int, radii, offsets, ops_at_level, albedo, edge_rate: tuple, t: float,
               dtype, device) -> SphereTree:
    """The chain (((s0 op1 s1) op2 s2) ...): leaf 0 at the root's frame
    origin, leaf i offset by ``offsets[i]`` along its edge; every edge e,
    numbered as a depth-first walk from the root numbers them (the left
    edge before the right), rotates about y by t * (rate0 + rate1 * e).
    Leaves are Lambertian. Transforms compose root to leaf in float32 on
    ``device``, then round to ``dtype``."""
    ops = [(PUSH, 0)]
    for level in range(1, levels):
        ops += [(PUSH, level), ({"union": UNION, "difference": DIFF,
                                 "intersection": INTERSECT}[ops_at_level[level]], 0)]
    # edges: the root's left spine first (its left edges e0 .. e_{levels-2}, down to
    # leaf 0), then each level's right edge, from the deepest binop up
    n_edges = 2 * (levels - 1)
    offset = [[0.0, 0.0, 0.0]] * n_edges
    chains = [tuple(range(levels - 1))]  # leaf 0: every left edge
    for level in range(1, levels):
        right = levels - 1 + (level - 1)
        offset[right] = list(offsets[level])
        chains.append(tuple(range(levels - 1 - level)) + (right,))
    f32 = dict(dtype=torch.float32, device=device)
    tt = torch.as_tensor(t, **f32)
    idx = torch.arange(n_edges, **f32)
    half = 0.5 * (tt * (edge_rate[0] + edge_rate[1] * idx))
    zero = torch.zeros_like(half)
    edge_q = torch.stack([torch.cos(half), zero, torch.sin(half), zero], dim=-1)
    edge_q = torch.cat([edge_q, torch.tensor([[1.0, 0.0, 0.0, 0.0]], **f32)])
    edge_t = torch.cat([torch.tensor(offset, **f32), torch.zeros((1, 3), **f32)])
    depth = max(len(c) for c in chains)
    pad = torch.tensor([list(c) + [n_edges] * (depth - len(c)) for c in chains],
                       dtype=torch.int64, device=device)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).expand(levels, 4)
    pos = torch.zeros((levels, 3), **f32)
    for j in range(depth):
        pos = quat_rotate(q, edge_t[pad[:, j]]) + pos
        q = quat_multiply(q, edge_q[pad[:, j]])
    return SphereTree(tuple(ops), quat_conjugate(q).to(dtype), pos.to(dtype),
                      torch.tensor(radii, **f32).to(dtype),
                      torch.ones(levels, dtype=torch.int32, device=device),
                      torch.tensor(albedo, **f32).to(dtype),
                      torch.zeros(levels, **f32).to(dtype))

