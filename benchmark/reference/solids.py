"""Plain torch nearest hit of a union of small CSG solids on a half-space ground.

The scene is built here from the configuration file: each object is a
shape of two leaves joined by one operation (union, intersection or
difference), every size and offset of the shape times the object's scale,
the offsets added to its centre in x and z; the ground is a half-space
through the world origin. Leaves are numbered as the program's tape
numbers them: each object's two leaves in the file's order, the ground
last. No leaf is rotated, so a ray maps into a leaf's frame by
subtracting the leaf's origin alone.

Along a ray each leaf is inside over one interval (enter, exit), empty
when enter > exit, computed in float32 by the operations of the CUDA tape
kernel's ``leaf_interval`` (``csrc/tape_kernel.cu``):

- sphere of radius r: the expanded quadratic a = d.d, h = o.d,
  c = o.o - r r, disc = h h - a c; where disc >= 0, (-h -+ sqrt(disc)) x
  (1 / a), else (T_FAR, T_NEG);
- half-space {x : x.n <= 0}: dn = d.n, on = o.n, t0 = -on / dn; entering
  (dn < 0) gives (t0, T_FAR), else (T_NEG, t0); a ray parallel to the
  plane (dn == 0) is inside throughout or nowhere, by on <= 0;
- box of half extents h: per axis the slab (-h - o) x (1 / d) and
  (h - o) x (1 / d), ordered; an axis with d == 0 is inside throughout or
  nowhere, by |o| <= h; enter the largest of the three lows, exit the
  least of the highs;
- cylinder about local +y of radius r and half height h: the quadratic in
  x and z (a ray along the axis, a == 0, is inside throughout or nowhere,
  by o_x o_x + o_z o_z - r r <= 0), met with the slab in y, whose ends are
  divided by d_y, not multiplied by its reciprocal.

The surface of an operand is the smallest leaf boundary t in (1e-3, 5e8)
at which the operand's membership just below t (enter < t <= exit) and
just above it (enter <= t < exit) differ, the candidates taken leaf by
leaf, enter before exit, the first of equal ones winning; ``entering`` is
the membership just above. The root union is evaluated operand by
operand, the nearest of the operands' surfaces (the first of equal ones,
in the tape's order) and its ``entering``: that is the union's own flip
wherever the operands do not meet, and here they meet only where an
object's base lies on the ground, a set no ray from above the ground
reaches without passing a surface first. The program evaluates the same
operands, its clusters, the same way.

The hit's normal and material are those of the leaf whose surface lies
nearest the hit point, over every leaf in index order (strict <): sphere
|(|p| - r)|, half-space |p.n|, and for the box and the cylinder the signed
distance (outside distance less the inside one), as the kernel scores
them; the leaf's outward normal (the box's axis of the smallest gap, the
cylinder's side or cap by the nearer of the two) is turned against the
ray.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from .core import T_FAR, T_NEG, Hit, dot, sqrt
from .csg import DIFF, EPS, INTERSECT, SURFACE_CUTOFF, UNION

RAY_CHUNK = 1 << 17  # rays whose [rays x leaves] intervals are held at once
KINDS = {"lambertian": 1, "metal": 2}
OPERATIONS = {"union": UNION, "intersection": INTERSECT, "difference": DIFF}


def _empty_unless(inside: Tensor, like: Tensor):
    """(enter, exit), in the dtype of ``like``, of a ray inside throughout
    (inside) or nowhere."""
    far = torch.full_like(like, T_FAR)
    return torch.where(inside, -far, far), torch.where(inside, far, -far)


def _slab(lo: Tensor, ld: Tensor, he: Tensor, divide: bool):
    flat = ld == 0.0
    safe = torch.where(flat, torch.ones_like(ld), ld)
    if divide:
        ta, tb = (-he - lo) / safe, (he - lo) / safe
    else:
        inv = 1.0 / safe
        ta, tb = (-he - lo) * inv, (he - lo) * inv
    t_lo, t_hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    in_lo, in_hi = _empty_unless(torch.abs(lo) <= he, ta)
    return torch.where(flat, in_lo, t_lo), torch.where(flat, in_hi, t_hi)


def _quadratic(a: Tensor, hb: Tensor, c: Tensor):
    disc = hb * hb - a * c
    ok = disc >= 0.0
    sq = sqrt(torch.clamp(disc, min=0.0))
    return ok, sq


def _interval(kind: str, lo: Tensor, ld: Tensor, size: Tensor):
    """(enter, exit) [N, Lk] of leaves of one type, rays in their frames
    lo, ld [N, Lk, 3], sizes [Lk, 3]."""
    lx, ly, lz = lo[..., 0], lo[..., 1], lo[..., 2]
    dx, dy, dz = ld[..., 0], ld[..., 1], ld[..., 2]
    p0, p1, p2 = size[:, 0], size[:, 1], size[:, 2]
    if kind == "sphere":
        a = dot(ld, ld)
        hb = dot(lo, ld)
        ok, sq = _quadratic(a, hb, dot(lo, lo) - p0 * p0)
        inv_a = 1.0 / a
        return (torch.where(ok, (-hb - sq) * inv_a, T_FAR),
                torch.where(ok, (-hb + sq) * inv_a, T_NEG))
    if kind == "halfspace":
        dn = dx * p0 + dy * p1 + dz * p2
        on = lx * p0 + ly * p1 + lz * p2
        t0 = -on / dn  # inf or NaN where parallel: selected away
        entering = dn < 0.0
        enter, exit_ = torch.where(entering, t0, T_NEG), torch.where(entering, T_FAR, t0)
        in_enter, in_exit = _empty_unless(on <= 0.0, on)
        flat = dn == 0.0
        return torch.where(flat, in_enter, enter), torch.where(flat, in_exit, exit_)
    if kind == "box":
        enter, exit_ = _slab(lx, dx, p0, False)
        for o_a, d_a, h_a in ((ly, dy, p1), (lz, dz, p2)):
            lo_a, hi_a = _slab(o_a, d_a, h_a, False)
            enter, exit_ = torch.maximum(enter, lo_a), torch.minimum(exit_, hi_a)
        return enter, exit_
    # cylinder about local +y: radius p0, half height p1
    a = dx * dx + dz * dz
    hb = lx * dx + lz * dz
    c = lx * lx + lz * lz - p0 * p0
    ok, sq = _quadratic(a, hb, c)
    degen = a == 0.0
    inv_a = 1.0 / torch.where(degen, torch.ones_like(a), a)
    s_enter = torch.where(ok, (-hb - sq) * inv_a, T_FAR)
    s_exit = torch.where(ok, (-hb + sq) * inv_a, T_NEG)
    in_enter, in_exit = _empty_unless(c <= 0.0, c)
    s_enter, s_exit = torch.where(degen, in_enter, s_enter), torch.where(degen, in_exit, s_exit)
    c_lo, c_hi = _slab(ly, dy, p1, True)
    return torch.maximum(s_enter, c_lo), torch.minimum(s_exit, c_hi)


def _score(kind: str, loc: Tensor, size: Tensor):
    """(distance score [N, Lk], local outward normal [N, Lk, 3]) of leaves of
    one type at hit points in their frames loc [N, Lk, 3]."""
    lx, ly, lz = loc[..., 0], loc[..., 1], loc[..., 2]
    p0, p1, p2 = size[:, 0], size[:, 1], size[:, 2]
    one = torch.ones_like(lx)

    def sign(v):
        return torch.where(v >= 0.0, one, -one)

    if kind == "sphere":
        rad = sqrt(dot(loc, loc))
        return torch.abs(rad - p0), loc * (1.0 / torch.clamp(rad, min=1e-12))[..., None]
    if kind == "halfspace":
        return torch.abs(lx * p0 + ly * p1 + lz * p2), size.expand(loc.shape)
    zero = torch.zeros_like(lx)
    if kind == "box":
        gx, gy, gz = p0 - torch.abs(lx), p1 - torch.abs(ly), p2 - torch.abs(lz)
        mx, my, mz = (torch.clamp(-g, min=0.0) for g in (gx, gy, gz))
        outside = sqrt(mx * mx + my * my + mz * mz)
        inside = torch.clamp(torch.maximum(-gx, torch.maximum(-gy, -gz)), max=0.0)
        ax, ay, az = torch.abs(gx), torch.abs(gy), torch.abs(gz)
        is_x = (ax <= ay) & (ax <= az)  # the axis with the smallest gap
        is_y = ~is_x & (ay <= az)
        normal = torch.stack([torch.where(is_x, sign(lx), zero), torch.where(is_y, sign(ly), zero),
                              torch.where(is_x | is_y, zero, sign(lz))], dim=-1)
        return outside - inside, normal
    srad = sqrt(lx * lx + lz * lz)
    side = torch.abs(srad - p0)
    cap = torch.abs(torch.abs(ly) - p1)
    sqr, sqy = srad - p0, torch.abs(ly) - p1
    mr, mh = torch.clamp(sqr, min=0.0), torch.clamp(sqy, min=0.0)
    outside = sqrt(mr * mr + mh * mh)
    inside = torch.clamp(torch.maximum(sqr, sqy), max=0.0)
    inv = 1.0 / torch.clamp(srad, min=1e-12)
    use_side = side < cap
    normal = torch.stack([torch.where(use_side, lx * inv, zero),
                          torch.where(use_side, zero, sign(ly)),
                          torch.where(use_side, lz * inv, zero)], dim=-1)
    return outside - inside, normal


def _nearest_flip(cands: Tensor, members: list, op) -> tuple[Tensor, Tensor]:
    """The first smallest flipping candidate of each operand: cands
    [N, G, C] (leaf by leaf, enter before exit), members the operand's
    leaves' (enter, exit) [N, G] each, op its operation (None: one leaf)."""
    tj = cands

    def fold(mem):
        if op is None:
            return mem[0]
        a, b = mem
        return a | b if op == UNION else a & b if op == INTERSECT else a & ~b

    below = fold([(e[..., None] < tj) & (x[..., None] >= tj) for e, x in members])
    above = fold([(e[..., None] <= tj) & (x[..., None] > tj) for e, x in members])
    flip = (below != above) & (tj > EPS) & (tj < SURFACE_CUTOFF)
    cand = torch.where(flip, tj, torch.full_like(tj, T_FAR))
    first = torch.argmin(cand, dim=-1, keepdim=True)  # first minimum
    t = torch.gather(cand, -1, first)[..., 0]
    return t, torch.gather(above & flip, -1, first)[..., 0]


@dataclass(frozen=True)
class Solids:
    types: tuple  # each leaf's type: "sphere", "halfspace", "box" or "cylinder"
    pos: Tensor  # [L, 3] leaf origin, world
    size: Tensor  # [L, 3] radius; unit outward normal; half extents; radius, half height
    mat_kind: Tensor  # [L] int32
    albedo: Tensor  # [L, 3]
    mat_param: Tensor  # [L] metal fuzz
    operands: tuple  # the root union's operands in order: (operation or None, leaf ids)

    @property
    def num_leaves(self) -> int:
        return len(self.types)

    @staticmethod
    def build(scene: dict, dtype, device) -> "Solids":
        """The configuration's objects and ground, sizes and offsets
        computed in float64 as the file gives them, rounded to float32 on
        ``device``, then to ``dtype``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        types, pos, size, kind, albedo, param, operands = [], [], [], [], [], [], []

        def leaf(kind_name, at, dims, material, rgb, fuzz):
            types.append(kind_name)
            pos.append(at)
            size.append(list(dims) + [0.0] * (3 - len(dims)))
            kind.append(KINDS[material])
            albedo.append(rgb)
            param.append(fuzz if material == "metal" else 0.0)
            return len(types) - 1

        for obj in scene["objects"]:
            shape = scene["shapes"][obj["shape"]]
            (cx, cz), s = obj["centre"], obj["scale"]
            ids = tuple(leaf(lf["type"], [cx + lf["at"][0] * s, lf["at"][1] * s,
                                          cz + lf["at"][2] * s],
                             [v * s for v in lf["size"]], lf["material"],
                             lf.get("albedo", obj["albedo"]), obj["fuzz"])
                        for lf in shape["leaves"])
            operands.append((OPERATIONS[shape["op"]], ids))
        g = scene["ground"]
        operands.append((None, (leaf(g["type"], [0.0, 0.0, 0.0], g["normal"], g["material"],
                                     g["albedo"], 0.0),)))
        f32 = dict(dtype=torch.float32, device=device)
        return Solids(tuple(types), torch.tensor(pos, **f32).to(dtype),
                      torch.tensor(size, **f32).to(dtype),
                      torch.tensor(kind, dtype=torch.int32, device=device),
                      torch.tensor(albedo, **f32).to(dtype), torch.tensor(param, **f32).to(dtype),
                      tuple(operands))

    def _by_type(self):
        for kind in sorted(set(self.types)):
            yield kind, [i for i, t in enumerate(self.types) if t == kind]

    def intervals(self, o: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
        """(enter, exit) [N, L] of every leaf along rays [N, 3]."""
        shape = (o.shape[0], self.num_leaves)
        enter = torch.empty(shape, dtype=o.dtype, device=o.device)
        exit_ = torch.empty_like(enter)
        for kind, idx in self._by_type():
            lo = o[:, None, :] - self.pos[idx]
            ld = d[:, None, :].expand(lo.shape)
            enter[:, idx], exit_[:, idx] = _interval(kind, lo, ld, self.size[idx])
        return enter, exit_

    def surface(self, o: Tensor, d: Tensor) -> tuple[Tensor, Tensor]:
        """(t [N], entering [N]) of the root union, operand by operand: t is
        T_FAR where no operand has a surface."""
        e, x = self.intervals(o, d)
        n, n_ops = o.shape[0], len(self.operands)
        t_all = torch.full((n, n_ops), T_FAR, dtype=o.dtype, device=o.device)
        ent_all = torch.zeros((n, n_ops), dtype=torch.bool, device=o.device)
        groups: dict = {}
        for k, (op, ids) in enumerate(self.operands):
            groups.setdefault((op, len(ids)), []).append((k, ids))
        for (op, width), members in groups.items():
            at = [k for k, _ in members]
            leaves = [[ids[j] for _, ids in members] for j in range(width)]
            pairs = [(e[:, cols], x[:, cols]) for cols in leaves]  # [N, G] each
            cands = torch.stack([v for pair in pairs for v in pair], dim=-1)  # [N, G, 2 width]
            t_all[:, at], ent_all[:, at] = _nearest_flip(cands, pairs, op)
        first = torch.argmin(t_all, dim=-1, keepdim=True)  # the first nearest operand
        return torch.gather(t_all, -1, first)[:, 0], torch.gather(ent_all, -1, first)[:, 0]

    def attribution(self, p: Tensor) -> tuple[Tensor, Tensor]:
        """(owner [N], its local outward normal [N, 3]) at hit points [N, 3]:
        the first leaf of least score."""
        shape = (p.shape[0], self.num_leaves)
        score = torch.empty(shape, dtype=p.dtype, device=p.device)
        normal = torch.empty(shape + (3,), dtype=p.dtype, device=p.device)
        for kind, idx in self._by_type():
            score[:, idx], normal[:, idx] = _score(kind, p[:, None, :] - self.pos[idx],
                                                   self.size[idx])
        owner = torch.argmin(score, dim=-1)  # first minimum: strict < in leaf order
        return owner, torch.gather(normal, 1, owner[:, None, None].expand(-1, 1, 3))[:, 0]

    def _hit(self, o: Tensor, d: Tensor) -> Hit:
        t, entering = self.surface(o, d)
        hit = t < SURFACE_CUTOFF
        t_safe = torch.where(hit, t, torch.ones_like(t))
        owner, nw = self.attribution(o + t_safe[:, None] * d)
        sgn = torch.where(dot(d, nw) > 0.0, -1.0, 1.0).to(nw.dtype)
        return Hit(t, hit, nw * sgn[:, None], entering, self.mat_kind[owner],
                   self.albedo[owner], self.mat_param[owner])

    def nearest_hit(self, o: Tensor, d: Tensor) -> Hit:
        batch = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        parts = [self._hit(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                 for s in range(0, o.shape[0], RAY_CHUNK)]
        h = Hit(*(torch.cat(vs) for vs in zip(*parts)))
        return Hit(*(v.reshape(batch + v.shape[1:]) for v in h))
