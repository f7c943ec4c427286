"""Vector math over trailing-dimension-3 tensors.

Twin of ``csgrenderer_tpu/math/vec.py``: every op broadcasts over leading
batch dimensions of ``[..., 3]`` tensors.

``normalized_ref_bugcompat`` keeps the reference C library's quirk of
dividing by the length SQUARED (``wmath.impl.h:48-55``); ``normalized`` is
the correct math.
"""

from __future__ import annotations

import torch
from torch import Tensor


def vec3(x, y, z, dtype=torch.float32) -> Tensor:
    """Build a [..., 3] vector by stacking the broadcast components along
    the last axis, on the device of the first tensor given (else the CPU)."""
    device = next((c.device for c in (x, y, z) if isinstance(c, Tensor)), None)
    parts = (torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z))
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def dot(v: Tensor, w: Tensor) -> Tensor:
    """Dot product over the trailing axis; returns [...].

    Summed left to right as written, so the CUDA kernel can repeat the
    exact float operations of this plain version.
    """
    return v[..., 0] * w[..., 0] + v[..., 1] * w[..., 1] + v[..., 2] * w[..., 2]


def sqrt(x: Tensor) -> Tensor:
    """Correctly rounded square root on every device.

    torch's float32 ``sqrt`` on the CPU is off by one ulp for a few inputs
    (0.3% of random ray-sphere discriminants), where XLA's and CUDA's
    ``sqrtf`` round correctly. A float32 square root taken in float64 and
    rounded back is correctly rounded, so CPU tensors go through float64.
    """
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def lengthsqr(v: Tensor) -> Tensor:
    return dot(v, v)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(lengthsqr(v))


def normalized(v: Tensor, eps: float = 0.0) -> Tensor:
    """v / |v| (the correct math; see module docstring)."""
    return v * torch.rsqrt(torch.clamp(lengthsqr(v), min=eps))[..., None]


def normalized_ref_bugcompat(v: Tensor) -> Tensor:
    """Reference quirk: scales by 1/length^2 (``wmath.impl.h:48-55``)."""
    return v / lengthsqr(v)[..., None]


def cross(v: Tensor, w: Tensor) -> Tensor:
    v, w = torch.broadcast_tensors(v, w)
    return torch.linalg.cross(v, w, dim=-1)


def reflect(v: Tensor, n: Tensor) -> Tensor:
    """Mirror v about the plane with unit normal n: v - 2 (v.n) n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Tensor, n: Tensor, etai_over_etat: Tensor) -> Tensor:
    """Snell refraction of unit vector uv about unit normal n (RTIOW form)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = -torch.sqrt(torch.abs(1.0 - lengthsqr(r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel


def lerp(a: Tensor, b: Tensor, t) -> Tensor:
    """(1-t)*a + t*b; t is a per-element scalar, broadcast over components."""
    t = torch.as_tensor(t)[..., None]
    return (1.0 - t) * a + t * b
