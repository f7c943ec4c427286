"""Plain torch nearest hit over a triangle soup, with conservative culling.

The scene's triangles are built here from the configuration file: an
icosphere is the icosahedron of the twelve vertices (+-1, +-phi, 0),
(0, +-1, +-phi), (+-phi, 0, +-1), each normalised, subdivided ``subdiv``
times by splitting every face (a, b, c) into (a, ab, ca), (b, bc, ab),
(c, ca, bc), (ab, bc, ca), where ab is the normalised midpoint a + b; its
vertices are scaled by the radius and moved to the centre in float64, then
rounded to float32. A floor quad p0..p3 is the two faces (p0, p1, p2) and
(p0, p2, p3). Each face is (v0, e1 = v1 - v0, e2 = v2 - v0), the edges taken
in float32. The faces come in the order the program's mesh builder gives
them: the icospheres in the configuration's order, each face list in the
order of the split above (face 4k..4k+3 are the children of face k of the
level before), then the floor.

Each ray is tested against a face by the textbook Möller-Trumbore test in
float32, in the operation order the CUDA mesh kernel documents for its
plain twin (``render/trimesh.mt_t``): p = d x e2, det = e1.p, 1/det, s = o -
v0, u = s.p / det, q = s x e1, v = d.q / det, t = e2.q / det, each dot summed
left to right; a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t >
1e-3. The nearest hit is the least t, and among equal t the lowest face
index. The hit shades with the face's unit normal (e1 x e2 over its length)
turned against the ray.

Testing every ray against each of 102,402 faces would take hours for a
1280x720/16-spp frame in torch, so a ray tests only the faces it can hit:
each object (an icosphere) is bounded by a box, and each fixed block of
``BLOCK`` consecutive faces of an object by a box, both padded by
``BOX_MARGIN``; a ray tests the faces of the blocks whose box it crosses
(a slab test), and the floor's faces always. Subdivision keeps a block
local (a block of 64 consecutive faces of a subdivided icosphere is the 64
descendants of one face two levels up, a small spherical patch). The box
test only skips faces that the ray cannot hit, and a face's test is the
same arithmetic whether or not others were skipped, so the culled nearest
hit equals the uncut one (``cull=False``), which the tests hold exactly.
The nearest hit over the tested faces is the least (t, index) pair, taken
as one int64 key (t's float32 bits above the index: a positive float's
bits order as the float does), so the order in which blocks are visited
does not matter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from .core import Hit, dot

EPS = 1e-3  # t_min of every segment
MISS = 1e30  # t of a face that is not hit
HIT_CUT = 5e29  # a nearest t below this is a hit
BLOCK = 64  # consecutive faces one block box bounds
BOX_MARGIN = 1e-3  # world units around each box
PAIR_TESTS = 1 << 24  # (ray, face) tests made at once
RAY_CHUNK = 1 << 21
KINDS = {"lambertian": 1, "metal": 2, "dielectric": 3}
ICOSAHEDRON_FACES = (
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
)


def icosphere(center, radius: float, subdiv: int):
    """(vertices [V, 3] float32, faces [F, 3] int64) of an icosphere: the
    subdivided unit icosahedron in float64, scaled and moved, then rounded."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    base = np.asarray([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                       [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                       [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    verts = [np.asarray(v) for v in base]
    faces = list(ICOSAHEDRON_FACES)
    middle: dict = {}

    def mid(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in middle:
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            middle[key] = len(verts)
            verts.append(m)
        return middle[key]

    for _ in range(subdiv):
        split = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    v = np.stack(verts) * float(radius) + np.asarray(center, np.float64)
    return v.astype(np.float32), np.asarray(faces, np.int64)


def quad(corners):
    """(vertices [4, 3] float32, faces [2, 3]) of a quad p0..p3 in winding order."""
    return np.asarray(corners, np.float32), np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mt_t(o, d, v0, e1, e2) -> Tensor:
    """Möller-Trumbore t, ``MISS`` where not hit; every argument a 3-tuple
    of broadcastable tensors (rays [N, 1] against faces [N, K] or [1, K])."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv_det = 1.0 / det
    s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = _dot(s, p) * inv_det
    q = _cross(s, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    hit = (det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return torch.where(hit, t, MISS)


def _split(x: Tensor):
    return x[..., 0], x[..., 1], x[..., 2]


def _keys(t: Tensor, ids: Tensor) -> Tensor:
    """int64 keys ordered as (t, face index): t >= 0 in its float32 bits above the index."""
    return (t.float().view(torch.int32).to(torch.int64) << 32) | ids


def crosses(o: Tensor, d: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """[N, K]: whether ray n (float32 [N, 3]) meets box k ([K, 3] corners)
    at some t > 0 (slab test)."""
    flat = d == 0.0
    inv = 1.0 / torch.where(flat, torch.ones_like(d), d)
    ta = torch.nan_to_num((lo[None] - o[:, None]) * inv[:, None], nan=0.0)
    tb = torch.nan_to_num((hi[None] - o[:, None]) * inv[:, None], nan=0.0)
    inside = (o[:, None] >= lo[None]) & (o[:, None] <= hi[None])
    big = torch.full((), MISS, dtype=o.dtype, device=o.device)
    near = torch.where(flat[:, None], torch.where(inside, -big, big), torch.minimum(ta, tb))
    far = torch.where(flat[:, None], torch.where(inside, big, -big), torch.maximum(ta, tb))
    near, far = near.amax(dim=-1), far.amin(dim=-1)
    return (far >= near) & (far > 0.0)


@dataclass(frozen=True)
class Part:
    """One object of the scene as the configuration gives it: its vertices
    and faces, its material, and whether its faces are culled by boxes
    (an icosphere) or tested by every ray (the floor)."""

    verts: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int64
    kind: int
    albedo: tuple
    param: float
    culled: bool


@dataclass(frozen=True)
class Boxes:
    """The boxes of one culled object: the object's, and each of its blocks'
    (faces ``starts[k]`` to ``ends[k]``)."""

    lo: Tensor  # [1, 3] float32
    hi: Tensor
    starts: Tensor  # [K] int64
    ends: Tensor
    block_lo: Tensor  # [K, 3] float32
    block_hi: Tensor


@dataclass(frozen=True)
class MeshSoup:
    v0: Tensor  # [F, 3]
    e1: Tensor
    e2: Tensor
    normal: Tensor  # [F, 3] unit
    mat_kind: Tensor  # [F] int32
    albedo: Tensor  # [F, 3]
    mat_param: Tensor  # [F]
    always: Tensor  # face ids every ray tests
    objects: tuple  # the Boxes of each culled object
    cull: bool = True

    @property
    def num_faces(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def build(parts: list, dtype, device, cull: bool = True) -> "MeshSoup":
        """From the scene's parts in face order: the faces in float32, then
        in ``dtype``; the boxes from the float32 vertices (in the control's
        bfloat16 a face can lie past its box's margin, and a ray then misses
        what the uncut bfloat16 test would have hit far off the face)."""
        # every product here is elementwise; no later matmul or convolution
        # may take a TF32 path either
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f32 = dict(dtype=torch.float32, device=device)
        v0s, e1s, e2s, kinds, albedos, params = [], [], [], [], [], []
        always, objects, first = [], [], 0
        for part in parts:
            v = torch.tensor(part.verts, dtype=torch.float32)
            f = torch.tensor(part.faces)
            v0 = v[f[:, 0]]
            v0s.append(v0)
            e1s.append(v[f[:, 1]] - v0)
            e2s.append(v[f[:, 2]] - v0)
            n = f.shape[0]
            kinds += [part.kind] * n
            albedos += [list(part.albedo)] * n
            params += [part.param] * n
            if not part.culled:
                always += range(first, first + n)
            else:
                corners = part.verts[part.faces].astype(np.float64)  # [n, 3, 3]
                starts = list(range(0, n, BLOCK))
                ends = [min(s + BLOCK, n) for s in starts]
                lo = np.stack([corners[s:e].min(axis=(0, 1)) for s, e in zip(starts, ends)])
                hi = np.stack([corners[s:e].max(axis=(0, 1)) for s, e in zip(starts, ends)])
                objects.append(Boxes(
                    torch.tensor(lo.min(axis=0)[None] - BOX_MARGIN, **f32),
                    torch.tensor(hi.max(axis=0)[None] + BOX_MARGIN, **f32),
                    torch.tensor(starts, device=device) + first,
                    torch.tensor(ends, device=device) + first,
                    torch.tensor(lo - BOX_MARGIN, **f32), torch.tensor(hi + BOX_MARGIN, **f32)))
            first += n
        v0, e1, e2 = (torch.cat(x).to(device) for x in (v0s, e1s, e2s))
        c = torch.stack(_cross(_split(e1), _split(e2)), dim=-1)
        normal = c * torch.rsqrt(torch.clamp(dot(c, c), min=1e-20))[..., None]
        return MeshSoup(v0.to(dtype), e1.to(dtype), e2.to(dtype), normal.to(dtype),
                        torch.tensor(kinds, dtype=torch.int32, device=device),
                        torch.tensor(albedos, **f32).to(dtype),
                        torch.tensor(params, **f32).to(dtype),
                        torch.tensor(always, dtype=torch.int64, device=device), tuple(objects),
                        cull)

    def _faces(self, ids: Tensor):
        return tuple(_split(x[ids]) for x in (self.v0, self.e1, self.e2))

    def _test_pairs(self, o, d, rays: Tensor, first: Tensor, count: Tensor, width: int,
                    best: Tensor) -> None:
        """Ray ``rays[i]`` against faces first[i] .. first[i] + count[i] - 1
        (at most ``width``), for each i; the least keys into ``best``."""
        step = max(1, PAIR_TESTS // width)
        cols = torch.arange(width, device=o.device)
        for s in range(0, rays.numel(), step):
            r, f0, n = rays[s:s + step], first[s:s + step], count[s:s + step]
            valid = cols[None, :] < n[:, None]
            ids = torch.where(valid, f0[:, None] + cols[None, :], 0)
            t = mt_t(tuple(x[:, None] for x in _split(o[r])),
                     tuple(x[:, None] for x in _split(d[r])), *self._faces(ids))
            t = torch.where(valid, t, MISS)
            best.scatter_reduce_(0, r, _keys(t, ids).amin(dim=1), "amin")

    def _nearest(self, o: Tensor, d: Tensor) -> Tensor:
        """Keys of the nearest hits of flat rays (``MISS`` where none)."""
        n, dev = o.shape[0], o.device
        best = _keys(torch.full((n,), MISS, dtype=o.dtype, device=dev),
                     torch.zeros(n, dtype=torch.int64, device=dev))
        every = torch.arange(n, device=dev)
        if not self.cull:
            f = self.num_faces
            for s in range(0, f, BLOCK):
                width = min(BLOCK, f - s)
                self._test_pairs(o, d, every, torch.full((n,), s, device=dev),
                                 torch.full((n,), width, device=dev), width, best)
            return best
        if self.always.numel():
            g = self.always.numel()
            t = mt_t(tuple(x[:, None] for x in _split(o)), tuple(x[:, None] for x in _split(d)),
                     *self._faces(self.always[None, :]))
            best = torch.minimum(best, _keys(t, self.always[None, :].expand(n, g)).amin(dim=1))
        o32, d32 = o.float(), d.float()
        for obj in self.objects:
            rays = torch.nonzero(crosses(o32, d32, obj.lo, obj.hi)[:, 0])[:, 0]
            if rays.numel() == 0:
                continue
            pair_ray, pair_block = torch.nonzero(
                crosses(o32[rays], d32[rays], obj.block_lo, obj.block_hi), as_tuple=True)
            if pair_ray.numel() == 0:
                continue
            starts = obj.starts[pair_block]
            self._test_pairs(o, d, rays[pair_ray], starts, obj.ends[pair_block] - starts, BLOCK,
                             best)
        return best

    def nearest_hit(self, o: Tensor, d: Tensor) -> Hit:
        batch = o.shape[:-1]
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        key = torch.cat([self._nearest(o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                         for s in range(0, o.shape[0], RAY_CHUNK)])
        t = (key >> 32).to(torch.int32).view(torch.float32).to(o.dtype)
        idx = key & 0xFFFFFFFF
        hit = t < HIT_CUT
        n_geo = self.normal[idx]
        front = dot(d, n_geo) < 0.0
        n = torch.where(front[:, None], n_geo, -n_geo)
        h = Hit(t, hit, n, front, self.mat_kind[idx], self.albedo[idx], self.mat_param[idx])
        return Hit(*(x.reshape(batch + x.shape[1:]) for x in h))


def parts_of(scene: dict) -> list:
    """The parts of a configuration's ``scene`` (``mesh_demo_scene``'s
    layout): its icospheres at ``subdiv``, then its floor quad."""
    parts = []
    for s in scene["spheres"]:
        verts, faces = icosphere(s["center"], s["radius"], scene["subdiv"])
        param = s.get("fuzz", s.get("index", 0.0))
        parts.append(Part(verts, faces, KINDS[s["kind"]], tuple(s.get("albedo", (1.0, 1.0, 1.0))),
                          param, True))
    fl = scene["floor"]
    verts, faces = quad(fl["corners"])
    parts.append(Part(verts, faces, KINDS[fl["kind"]], tuple(fl["albedo"]), 0.0, False))
    return parts
