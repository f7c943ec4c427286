from . import vec
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
)

__all__ = [
    "vec",
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
