"""Roofline floors: the least time an NVIDIA H100 SXM could take for a frame.

A kernel's share of its roofline is this floor over the kernel's device
time in the traced window. The floor is the larger of the frame's FP32
operations over the published peak of 67 TFLOP/s (an FMA counts as two)
and its bytes over the published 3.35 TB/s of HBM3 (NVIDIA's H100 SXM data
sheet, dense rates, at the card's full 700 W; the result line records the
card's power limit beside them). No clock read during a run enters it.

The operation table is the port's own count of each step's FP32
operations (a product, a sum, a compare, a select, a divide, a square root
or an exponential counts one), as ``chip_smoke.py`` counts them. The
floors count only work that depends on nothing but the configuration and
the frame's segments and hits, so they read the same work whatever
implements the frame:

- a path segment sets up its ray and its hit test (``ray`` + ``segment``);
- a segment that hits tests the primitives that decide the hit: on a
  sphere soup the one sphere it hits; in a CSG tree every leaf's interval
  (the tree's membership at a t depends on every leaf) and the flip test
  of both interval ends of each leaf; then it shades the hit (on a tree,
  with the hit leaf's normal);
- a segment that misses takes the sky.

Grid-walk visits, clusters and the program's globals are left out: they
are choices of an implementation. Hits are the floor ``segments - pixels x
spp`` (a path misses at most once), and segments are the renderer's own
count, which the correctness check holds to the plain reference's. Bytes
are the frame's outputs written once and the scene read once.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # FP32, non-tensor, FMA counted as two operations
PEAK_BYTES_PER_S = 3.35e12  # HBM3

OPS = {
    "ray": 16,  # o.d, o.o, d.d, 1/d.d
    "segment": 12,  # 1/|d|, the unit direction, the hit test
    "sphere_test": 20,  # the quadratic up to the disc test, and the t < t_best test
    "sphere_hit": 58,  # hit point, normal, front test, face-forward, a Lambertian scatter
    "miss": 17,  # the sky gradient, added
    "leaf_transform": 63,  # o - pos and two quaternion rotations
    "sphere_interval": 29,  # a sphere leaf's enter and exit
    "candidate_test": 1,  # tj > eps
    "tape_hit": 85,  # hit point, the leaf normal to world, face-forward, scatter
    "sphere_attribution": 47,  # the hit leaf: transform, distance to its surface, normal
    "gbuffer_hit": 31,  # hit point 6, normal 6, face-forward 9, depth 7, albedo 3
    # the a-trous filter, per pixel and pass unless named
    "atrous_pixel": 10,  # once a pixel: albedo clamp, divide, multiply back; depth select
    "atrous_centre": 9,  # centre luminance (5) and the normalisation (4)
    "atrous_tap": 23,  # luminance and depth weights, hit gate, product, accumulation
    "atrous_both_hit": 7,  # where both pixels hit: normal dot, max, the product
}
NORMAL_SQUARINGS = 5  # sigma_n = 32 = 2^5: five squarings where both pixels hit
RGB_F32 = 12  # bytes of a radiance pixel
GBUFFER_PIXEL = 4 + 12 + 12 + 1  # depth, normal, albedo, hit
SPHERE_BYTES = 36  # centre, radius, kind, albedo, parameter
LEAF_BYTES = 64  # rotation, origin, parameters, kind, parameter, albedo


def floor_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hits_floor(segments: int, pixels: int, spp: int) -> int:
    return max(int(segments) - pixels * spp, 0)


def sphere_frame(segments: int, pixels: int, spp: int, n_spheres: int, sky: str = "rtiow"):
    """(ops, bytes) of a sphere-soup frame of ``segments`` path segments."""
    hits = hits_floor(segments, pixels, spp)
    miss = 0 if sky == "black" else OPS["miss"]
    ops = (segments * (OPS["ray"] + OPS["segment"])
           + hits * (OPS["sphere_test"] + OPS["sphere_hit"]) + (segments - hits) * miss)
    return ops, pixels * RGB_F32 + n_spheres * SPHERE_BYTES


def tape_frame(segments: int, pixels: int, spp: int, n_leaves: int, sky: str = "rtiow"):
    """(ops, bytes) of a frame of a CSG tree of ``n_leaves`` sphere leaves."""
    hits = hits_floor(segments, pixels, spp)
    miss = 0 if sky == "black" else OPS["miss"]
    per_hit = (n_leaves * (OPS["leaf_transform"] + OPS["sphere_interval"]
                           + 2 * OPS["candidate_test"])
               + OPS["tape_hit"] + OPS["sphere_attribution"])
    ops = segments * OPS["segment"] + hits * per_hit + (segments - hits) * miss
    return ops, pixels * RGB_F32 + n_leaves * LEAF_BYTES


def gbuffer_frame(pixels: int, hits: int, n_spheres: int):
    """(ops, bytes) of one G-buffer cast: a centred primary ray a pixel."""
    ops = pixels * (OPS["ray"] + OPS["segment"]) + hits * (OPS["sphere_test"] + OPS["gbuffer_hit"])
    return ops, pixels * GBUFFER_PIXEL + n_spheres * SPHERE_BYTES


def atrous_frame(pixels: int, passes: int, both_hit_taps: list):
    """(ops, bytes) of the demodulated filter: ``both_hit_taps[i]`` is the
    number of (pixel, tap) pairs of pass i where both pixels hit. Bytes:
    colour, albedo, normal (12 each), depth (4), hit (1) read once, the
    image (12) written once."""
    ops = pixels * OPS["atrous_pixel"]
    for i in range(passes):
        ops += pixels * (OPS["atrous_centre"] + 25 * OPS["atrous_tap"])
        ops += both_hit_taps[i] * (OPS["atrous_both_hit"] + NORMAL_SQUARINGS)
    return ops, pixels * (12 + 12 + 12 + 4 + 1 + 12)


def share_percent(floor_s: float, kernel_s: float) -> float | None:
    """100 x floor / kernel time; None when the trace holds no kernel time."""
    if kernel_s <= 0.0:
        return None
    return 100.0 * floor_s / kernel_s
