"""Linear radiance -> displayable image: gamma, exposure, quantisation.

Twin of ``csgrenderer_tpu/render/tonemap.py``. RTIOW uses gamma 2 (sqrt);
the milestone-01 compatibility path uses ``gamma=1.0``.
"""

from __future__ import annotations

import torch
from torch import Tensor


def tonemap(linear: Tensor, gamma: float = 2.0, exposure: float = 1.0) -> Tensor:
    """Clamped gamma-corrected image in [0, 1]."""
    x = torch.clamp(linear * exposure, 0.0, 1.0)
    if gamma == 1.0:
        return x
    if gamma == 2.0:
        return torch.sqrt(x)
    return x ** (1.0 / gamma)


def to_uint8(img01: Tensor, out: Tensor | None = None) -> Tensor:
    """The image quantised to uint8; written into ``out`` (uint8, of the
    image's shape) when given."""
    q = torch.clamp(img01 * 255.0 + 0.5, 0.0, 255.0)
    return q.to(torch.uint8) if out is None else out.copy_(q)
