"""The floor of a frame of a CSG union of many small solids, beside
``roofline.py``'s sphere and CSG floors (its peaks, its rules).

A path segment sets up its ray and its hit test (``roofline.py``'s
``ray`` + ``segment``). A segment that hits computes one leaf's interval
(its transform, ``leaf_transform``, and its interval at the cheapest leaf
type in the scene) and the flip tests of that interval's two ends, shades
the hit (``tape_hit``) and scores one leaf for the attribution, again at
the cheapest type; a segment that misses takes the sky. Bytes: the image
written once and each leaf's row of the leaf table read once.

Every other leaf's interval, the clusters, any bound test and the
attribution's other leaves are left out: which leaves a segment must
evaluate to find its surface is a choice of an implementation (a
hierarchy over the solids evaluates few), and the frame's leaf intervals
(``PathTraceRenderer.last_frame_leaf_tests``) say how many the program
evaluates. ``roofline.tape_frame`` counts every leaf at every hit, as
sphere leaves, which a culling evaluation would beat; this floor does not
move with such a change.

Operations per leaf type are the port's own count from the tape kernel's
``leaf_interval`` and ``leaf_score`` (``chip_smoke.py``'s ``OPS``:
``interval`` and ``attribution``), by its rule: a product, a sum, a
compare, a select, a divide or a square root counts one, and a branch not
taken on a ray in general position (a ray parallel to a face) counts
nothing.
"""

from __future__ import annotations

from . import roofline

# one leaf's (enter, exit), after its transform
INTERVAL_OPS = {"sphere": 29, "halfspace": 14, "box": 31, "cylinder": 34}
# one leaf of the attribution: the hit point's transform, the leaf's score
# and normal, the best-so-far test
ATTRIBUTION_OPS = {"sphere": 47, "halfspace": 40, "box": 69, "cylinder": 61}


def solids_frame(segments: int, pixels: int, spp: int, n_leaves: int, leaf_types,
                 sky: str = "rtiow"):
    """(ops, bytes) of a frame of ``segments`` path segments through a
    union of solids of ``n_leaves`` leaves of the types ``leaf_types``."""
    hits = roofline.hits_floor(segments, pixels, spp)
    miss = 0 if sky == "black" else roofline.OPS["miss"]
    per_hit = (roofline.OPS["leaf_transform"] + min(INTERVAL_OPS[t] for t in leaf_types)
               + 2 * roofline.OPS["candidate_test"] + roofline.OPS["tape_hit"]
               + min(ATTRIBUTION_OPS[t] for t in leaf_types))
    ops = (segments * (roofline.OPS["ray"] + roofline.OPS["segment"]) + hits * per_hit
           + (segments - hits) * miss)
    return ops, pixels * roofline.RGB_F32 + n_leaves * roofline.LEAF_BYTES
