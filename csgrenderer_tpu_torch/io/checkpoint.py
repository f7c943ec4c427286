"""Checkpoint/resume for progressive accumulation state.

Twin of ``csgrenderer_tpu/io/checkpoint.py``: the progressive accumulator
(sum of sample radiances and the sample count) and its ``.npz`` format,
with the same keys (``radiance_sum``, ``sample_count``, ``rays_traced``
and ``meta_<name>`` per metadata item), so a file written by either
package loads in the other. The JAX package's orbax variant is not ported
(ROADMAP, "not to port").
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor


class Accumulator(NamedTuple):
    """Progressive render state: running radiance sum and sample count."""

    radiance_sum: Tensor  # [H, W, 3] f32, linear, on the frame's device
    sample_count: Tensor  # [] int32, on the same device
    # A Python int: add() takes a frame's ray count as the int the
    # renderer read at its fence, or as an int64 tensor, which it reads
    # back (a sync)
    rays_traced: int

    @staticmethod
    def zeros(height: int, width: int, device=None) -> "Accumulator":
        return Accumulator(
            radiance_sum=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            sample_count=torch.zeros((), dtype=torch.int32, device=device),
            rays_traced=0,
        )

    def add(self, radiance: Tensor, samples: int, rays) -> "Accumulator":
        return Accumulator(
            radiance_sum=self.radiance_sum + radiance,
            sample_count=self.sample_count + samples,
            rays_traced=self.rays_traced + int(rays),
        )

    def image(self) -> Tensor:
        """Current mean-radiance estimate."""
        n = torch.clamp(self.sample_count, min=1)
        return self.radiance_sum / n.to(torch.float32)


def save(path, acc: Accumulator, **metadata) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        radiance_sum=acc.radiance_sum.detach().cpu().numpy(),
        sample_count=acc.sample_count.detach().cpu().numpy(),
        rays_traced=np.asarray(acc.rays_traced, np.int64),
        **{f"meta_{k}": np.asarray(v.detach().cpu() if isinstance(v, Tensor) else v)
           for k, v in metadata.items()},
    )


def load(path, device=None) -> tuple[Accumulator, dict]:
    """(the accumulator, on ``device``; the metadata as numpy arrays)."""
    with np.load(path) as z:
        acc = Accumulator(
            radiance_sum=torch.from_numpy(np.asarray(z["radiance_sum"], np.float32)).to(device),
            sample_count=torch.from_numpy(np.asarray(z["sample_count"], np.int32)).to(device),
            rays_traced=int(z["rays_traced"]),
        )
        meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
    return acc, meta
