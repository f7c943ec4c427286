"""Minimal Wavefront OBJ import/export for MeshScene.

Twin of ``csgrenderer_tpu/io/obj.py``. Supports the geometry subset that
matters for a triangle soup: ``v`` lines and ``f`` lines (1-based and
negative indices, ``v/vt/vn`` forms, polygons fan-triangulated).
Everything else is ignored.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (vertices [V,3] f32, faces [F,3] int64)."""
    verts: list = []
    faces: list = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v" and len(parts) >= 4:
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif parts[0] == "f" and len(parts) >= 4:
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):  # fan triangulation
                faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"no triangles in OBJ file {path}")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def write_obj(path, vertices, faces) -> None:
    lines = [f"# csgrenderer-tpu mesh: {len(faces)} triangles"]
    for v in np.asarray(vertices, np.float64):
        lines.append(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}")
    for f in np.asarray(faces, np.int64):
        lines.append(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}")
    Path(path).write_text("\n".join(lines) + "\n")


def load_mesh(path, material, device=None):
    """OBJ file -> MeshScene with one material, on ``device``."""
    from ..render.trimesh import make_mesh

    verts, faces = read_obj(path)
    return make_mesh(verts, faces, material, device)
