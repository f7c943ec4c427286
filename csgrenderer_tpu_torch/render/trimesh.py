"""Triangle meshes: a triangle soup with per-face materials.

Twin of ``csgrenderer_tpu/render/trimesh.py``: ``MeshScene`` (v0 and the
two edge vectors per face, struct of arrays), a Möller-Trumbore nearest
hit with the same ``SurfaceHit`` contract as ``SphereScene`` (so it plugs
into ``integrator.render_image``), and the numpy builders ``make_mesh``,
``concat_meshes``, ``quad`` and ``icosphere``, which make the same bytes
as the JAX package's.

``nearest_hit`` repeats the jnp version's float operations in its order
(``csgrenderer_tpu/render/trimesh.py:58-69``): the CUDA mesh kernel
(``kernels/csrc/trimesh_kernel.cu``) repeats them again. It is chunked
over rays and faces so that no [rays, faces] temporary passes about
64 MB, whatever the mesh size.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch
from torch import Tensor

from ..math import vec
from .integrator import SurfaceHit

MISS = 1e30  # t of a face that is not hit
HIT_CUT = 5e29  # a nearest t below this is a hit
CHUNK_BYTES = 64 << 20  # bound on one [rays, faces] float32 temporary
RAY_CHUNK = 65536  # rays per pass of brute_nearest


def cross(a, b):
    """Component cross product a x b of 3-tuples of tensors, in
    ``jnp.cross``'s operation order."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def dot3(a, b):
    """Component dot product of 3-tuples, summed left to right."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mt_t(o, d, v0, e1, e2, eps: float = 1e-3) -> Tensor:
    """Möller-Trumbore t of rays against faces, MISS where not hit.

    Every argument is a 3-tuple of broadcastable tensors (rays [N, 1] and
    faces [1, C] give [N, C]). A degenerate face (det = 0) gets an
    infinite 1/det, so u or v is NaN or infinite and the tests reject it.
    """
    pvec = cross(d, e2)
    det = dot3(e1, pvec)
    inv_det = 1.0 / det
    tvec = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = dot3(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return torch.where(valid, t, MISS)


def _split(x: Tensor):
    return x[..., 0], x[..., 1], x[..., 2]


def brute_nearest(o: Tensor, d: Tensor, v0: Tensor, e1: Tensor, e2: Tensor, eps: float = 1e-3,
                  face_chunk: int | None = None) -> tuple[Tensor, Tensor]:
    """(t [N], face index [N] int64) of the nearest hit of flat rays [N, 3]
    over faces [F, 3]: the lowest index wins among equal t (``argmin``).
    Chunked over rays and faces; ``face_chunk`` caps the face chunk."""
    n, f = o.shape[0], v0.shape[0]
    t_best = torch.full((n,), MISS, dtype=torch.float32, device=o.device)
    id_best = torch.zeros((n,), dtype=torch.int64, device=o.device)
    if f == 0 or n == 0:
        return t_best, id_best
    rc = min(n, RAY_CHUNK)
    fc = max(1, min(f, CHUNK_BYTES // (4 * rc)))
    if face_chunk is not None:
        fc = max(1, min(fc, int(face_chunk)))
    faces = [(s, [tuple(c[None, :] for c in _split(x[s:s + fc])) for x in (v0, e1, e2)])
             for s in range(0, f, fc)]
    for r0 in range(0, n, rc):
        ro = tuple(c[:, None] for c in _split(o[r0:r0 + rc]))
        rd = tuple(c[:, None] for c in _split(d[r0:r0 + rc]))
        tb, ib = t_best[r0:r0 + rc], id_best[r0:r0 + rc]
        for s, (fv0, fe1, fe2) in faces:
            t = mt_t(ro, rd, fv0, fe1, fe2, eps)
            j = torch.argmin(t, dim=1)
            tj = torch.gather(t, 1, j[:, None])[:, 0]
            take = tj < tb  # strict: the earlier chunk wins ties
            tb = torch.where(take, tj, tb)
            ib = torch.where(take, j + s, ib)
        t_best[r0:r0 + rc], id_best[r0:r0 + rc] = tb, ib
    return t_best, id_best


@dataclass(frozen=True)
class MeshScene:
    """Triangle soup: v0 and edge vectors, per-face materials."""

    v0: Tensor  # [F, 3] f32
    e1: Tensor  # [F, 3] = v1 - v0
    e2: Tensor  # [F, 3] = v2 - v0
    mat_kind: Tensor  # [F] int32
    albedo: Tensor  # [F, 3]
    mat_param: Tensor  # [F]

    @property
    def num_faces(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "MeshScene":
        return MeshScene(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    @property
    def face_normals(self) -> Tensor:
        """Unit geometric normals (right-hand winding), as the jnp version
        forms them: ``normalized(cross(e1, e2), eps=1e-20)``."""
        return vec.normalized(torch.stack(cross(_split(self.e1), _split(self.e2)), dim=-1),
                              eps=1e-20)

    def surface_hit(self, d: Tensor, t: Tensor, idx: Tensor, normals: Tensor | None = None
                    ) -> SurfaceHit:
        """Shading inputs at the nearest hit (t, idx) of flat rays: the
        geometric normal turned against the ray; ``front_face`` from it."""
        n_all = self.face_normals if normals is None else normals
        n_geo = n_all[idx]
        front = vec.dot(d, n_geo) < 0.0
        n = torch.where(front[:, None], n_geo, -n_geo)
        return SurfaceHit(t=t, hit=t < HIT_CUT, normal=n, front_face=front,
                          mat_kind=self.mat_kind[idx], albedo=self.albedo[idx],
                          mat_param=self.mat_param[idx])

    def nearest_hit(self, o: Tensor, d: Tensor, eps: float = 1e-3,
                    face_chunk: int | None = None, normals: Tensor | None = None) -> SurfaceHit:
        """Möller-Trumbore over all faces; the first face of least t wins.
        ``normals``: unit face normals made once (else ``face_normals``)."""
        batch = o.shape[:-1]
        flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, idx = brute_nearest(flat_o, flat_d, self.v0, self.e1, self.e2, eps, face_chunk)
        h = self.surface_hit(flat_d, t, idx, normals)
        return SurfaceHit(*(x.reshape(batch + x.shape[1:]) for x in h))


def mesh_from_arrays(v0, e1, e2, mat_kind, albedo, mat_param, device=None) -> MeshScene:
    """MeshScene from the six per-face numpy arrays, copied as they are."""

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)

    mesh = MeshScene(
        v0=f32(v0), e1=f32(e1), e2=f32(e2),
        mat_kind=torch.from_numpy(np.array(mat_kind, dtype=np.int32, copy=True)).to(device),
        albedo=f32(albedo), mat_param=f32(mat_param),
    )
    f = mesh.num_faces
    shapes = [tuple(getattr(mesh, k.name).shape) for k in fields(mesh)]
    if shapes != [(f, 3), (f, 3), (f, 3), (f,), (f, 3), (f,)]:
        raise ValueError(f"inconsistent mesh arrays: {shapes}")
    return mesh


def make_mesh(vertices, faces, material, device=None) -> MeshScene:
    """A MeshScene from [V, 3] vertices, [F, 3] integer faces and one
    ``scene.Material`` for every face."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    n = f.shape[0]
    kind = np.full(n, material.kind, np.int32)
    alb = np.tile(np.asarray(material.albedo, np.float32), (n, 1))
    prm = np.full(n, material.param, np.float32)
    return mesh_from_arrays(v0, e1, e2, kind, alb, prm, device)


def concat_meshes(*meshes: MeshScene) -> MeshScene:
    return MeshScene(**{f.name: torch.cat([getattr(m, f.name) for m in meshes])
                        for f in fields(MeshScene)})


# -- procedural builders -----------------------------------------------------


def quad(p0, p1, p2, p3, material, device=None) -> MeshScene:
    """Two-triangle quad with corners in winding order."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    return make_mesh(verts, [[0, 1, 2], [0, 2, 3]], material, device)


def icosphere(center, radius, material, subdivisions: int = 1, device=None) -> MeshScene:
    """Subdivided icosahedron (outward winding)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    vlist = [tuple(v) for v in verts]
    cache: dict = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.asarray(vlist[a]) + np.asarray(vlist[b])
            m /= np.linalg.norm(m)
            cache[key] = len(vlist)
            vlist.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt

    v = np.asarray(vlist, np.float64) * float(radius) + np.asarray(center, np.float64)
    return make_mesh(v, faces, material, device)
