from . import quaternion, vec
from .vec import (
    cross,
    dot,
    length,
    lengthsqr,
    lerp,
    normalized,
    normalized_ref_bugcompat,
    reflect,
    refract,
    vec3,
)

__all__ = [
    "quaternion",
    "vec",
    "vec3",
    "dot",
    "cross",
    "length",
    "lengthsqr",
    "lerp",
    "normalized",
    "normalized_ref_bugcompat",
    "reflect",
    "refract",
]
