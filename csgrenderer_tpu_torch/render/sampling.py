"""Stateless, counter-based RNG + sampling for the path tracer.

Twin of ``csgrenderer_tpu/render/sampling.py``. Randomness is PCG4D
(Jarzynski & Olano, JCGT 2020) keyed by integer counters (pixel, sample,
bounce, seed), so an image does not depend on how the work is split, and
the CUDA kernel reproduces the same numbers with native ``uint32`` math.
No ``torch.Generator`` is involved.

PyTorch's ``uint32`` has no ``+`` and no ``>>`` on the CPU, so uint32
arithmetic is emulated in ``int64`` holding values in ``[0, 2**32)``.
Products are formed from 16-bit halves so no intermediate leaves the int64
range: wraparound mod 2**32 is then exact, not signed-overflow behaviour.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

_MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def _u32(x, like: Tensor | None = None) -> Tensor:
    device = None if like is None else like.device
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & _MASK


def _mul(a: Tensor, b: Tensor) -> Tensor:
    """a * b mod 2**32 for int64 tensors holding uint32 values."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d(a, b, c, d) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """PCG4D hash: four uint32 counters -> four well-mixed uint32 words.

    Counters may be Python ints or integer tensors of any width; they are
    taken mod 2**32 and broadcast together. Returns int64 tensors holding
    the uint32 words.
    """
    like = next((x for x in (a, b, c, d) if isinstance(x, Tensor)), None)
    v = list(torch.broadcast_tensors(*(_u32(x, like) for x in (a, b, c, d))))
    v = [(_mul(x, torch.full_like(x, _MUL)) + _INC) & _MASK for x in v]

    def mix(v):
        v[0] = (v[0] + _mul(v[1], v[3])) & _MASK
        v[1] = (v[1] + _mul(v[2], v[0])) & _MASK
        v[2] = (v[2] + _mul(v[0], v[1])) & _MASK
        v[3] = (v[3] + _mul(v[1], v[2])) & _MASK

    mix(v)
    v = [x ^ (x >> 16) for x in v]
    mix(v)
    return v[0], v[1], v[2], v[3]


def _to_unit_float(u: Tensor) -> Tensor:
    """uint32 -> f32 in [0, 1) from the top 24 bits (exactly representable)."""
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform4(a, b, c, d) -> Tensor:
    """[..., 4] uniforms in [0,1) from four integer counter arrays."""
    return torch.stack([_to_unit_float(w) for w in pcg4d(a, b, c, d)], dim=-1)


def sample_unit_vector(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform direction on the unit sphere from two uniforms; [..., 3]."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sample_in_unit_disk(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform point in the unit disk (polar warp); [..., 2]."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
