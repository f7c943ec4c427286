"""The triangle-mesh floor of a frame, beside ``roofline.py``'s sphere and
CSG floors (its peaks, its rules).

A path segment sets up its ray and its hit test (``roofline.py``'s
``ray`` + ``segment``); a segment that hits tests the one face it hits (a
Möller-Trumbore test and its t < t_best test, 52 operations) and shades
the hit (the hit point, the front test, the face-forward normal and a
Lambertian scatter, 52), as ``chip_smoke.py`` counts them (``mt_test``,
``mesh_hit``); a segment that misses takes the sky. Bytes: the image
written once and each face's 48-byte Möller-Trumbore record (v0, e1, e2
and a pad word) read once. The voxel walk, the faces it lists and the
globals every ray tests are choices of an implementation and are left
out, as ``roofline.py`` leaves out the sphere grid's walk: the frame's
triangle tests (``PathTraceRenderer.last_frame_tri_tests``) say how many
of them the program makes.
"""

from __future__ import annotations

from . import roofline

MESH_OPS = {
    "mt_test": 52,  # the Möller-Trumbore test of the face hit, and its t < t_best test
    "mesh_hit": 52,  # hit point, front test, face-forward, a Lambertian scatter
}
FACE_BYTES = 48  # v0, e1, e2 and a pad word, float32


def mesh_frame(segments: int, pixels: int, spp: int, n_faces: int, sky: str = "rtiow"):
    """(ops, bytes) of a frame of ``segments`` path segments through a mesh
    of ``n_faces`` faces."""
    hits = roofline.hits_floor(segments, pixels, spp)
    miss = 0 if sky == "black" else roofline.OPS["miss"]
    ops = (segments * (roofline.OPS["ray"] + roofline.OPS["segment"])
           + hits * (MESH_OPS["mt_test"] + MESH_OPS["mesh_hit"]) + (segments - hits) * miss)
    return ops, pixels * roofline.RGB_F32 + n_faces * FACE_BYTES
