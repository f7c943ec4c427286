"""The NEE term of the sphere kernel's roofline floor: the operations of
one shadow ray, beside ``roofline.py``'s sphere-soup floor.

Next-event estimation adds to a frame's floor, for every shadow ray it
traces, the lamp pick, the cone sample toward the picked lamp, the
vertex lobe's pdf toward that sample, the lamp's analytic hit and the
sample's validity tests, the balance-heuristic term, and the shadow
segment's ray set-up and occlusion verdict. Counted as ``roofline.py``
counts (a product, a sum, a compare, a select, a divide, a square root, a
sine or a cosine counts one; a negation counts nothing), step by step of
``nee_pick`` and ``nee_sample`` in ``kernels/csrc/path_common.cuh``,
which repeat the plain version's operations. Like the sphere floor it
takes the cheaper lobe (the Lambertian's) and leaves out the walk that
the shadow ray takes through the grid, NEE vertices whose sample is not
traced, and the partner weight of lamp emission: choices of an
implementation, or work the frame's counts do not give.

The shadow rays are the renderer's own count, which the cell's check holds
to the plain reference's (``shadow_gap``).
"""

from __future__ import annotations

from . import roofline

NEE_OPS = {
    "lamp_pick": 4,  # the three uniforms scaled to [0, 1), u0 x lamps
    "cone_sample": 67,  # to the centre, the cone's cosine, z, phi, the basis, the direction, 1/pdf
    "lobe_pdf": 7,  # cos toward the sample, the cosine lobe's max and 1/pi
    "lamp_hit": 28,  # the analytic lamp distance (25) and the sample's three validity tests
    "mis_term": 10,  # q, q / (1 + q), albedo x emission x the weight
    "shadow_segment": 18,  # tl x (1 - 1e-4), the ray's set-up (roofline's "ray"), the verdict
}
SHADOW_RAY = sum(NEE_OPS.values())  # 134 operations a shadow ray
LAMP_BYTES = 32  # a lamp row: centre, radius, emission, sphere id


def nee_frame(segments: int, shadow_rays: int, pixels: int, spp: int, n_spheres: int,
              n_lamps: int, sky: str = "black"):
    """(ops, bytes) of a sphere-soup frame with NEE: ``roofline.sphere_frame``
    of its ``segments``, plus ``SHADOW_RAY`` operations for each of its
    ``shadow_rays``, plus the lamp table read once."""
    ops, nbytes = roofline.sphere_frame(segments, pixels, spp, n_spheres, sky)
    return ops + shadow_rays * SHADOW_RAY, nbytes + n_lamps * LAMP_BYTES
