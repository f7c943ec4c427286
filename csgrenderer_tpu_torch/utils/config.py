"""Typed runtime configuration.

Twin of ``csgrenderer_tpu/utils/config.py``: ``RenderConfig`` and
``MeshConfig`` with the same fields, defaults and validation.

Debug mode: JAX's ``jax_debug_nans`` has no torch switch for code that
runs forward only, so ``RenderConfig(debug=True)`` makes the renderers
check every frame's radiance (``check_finite``) and raise at the first NaN
or Inf, and ``checked(fn)`` wraps one function the same way. Either check
reads the frame back to the host, so it synchronises with the device.

``denoise=True`` has the renderers filter each frame with
``denoise_iterations`` passes of the a-trous filter (``render/denoise.py``)
over the AOV G-buffer (``render/aov.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 16
    max_bounces: int = 8
    seed: int = 0
    sky: str = "rtiow"  # "rtiow" | "wololo" | "black"
    gamma: float = 2.0
    jitter: bool = True
    lens: bool = False
    nee: bool = False  # next-event estimation toward the scene's lamps
    debug: bool = False  # every frame's radiance must be finite
    denoise: bool = False  # a-trous filter on each frame, AOVs as edge stops
    denoise_iterations: int = 4

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("resolution must be positive")
        if self.spp <= 0 or self.max_bounces <= 0:
            raise ValueError("spp and max_bounces must be positive")
        if self.sky not in ("rtiow", "wololo", "black"):
            raise ValueError(f"bad sky mode {self.sky!r}")
        if self.denoise_iterations < 1:
            raise ValueError("denoise_iterations must be >= 1")

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def rays_per_frame(self) -> int:
        """Ray budget metric: W*H*spp*bounces (SURVEY §5 Mrays accounting)."""
        return self.width * self.height * self.spp * self.max_bounces


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-device rendering: the tile and sample
    ways of ``parallel.make_mesh``."""

    tile_axis: int = 1  # ways to shard image rows
    sample_axis: int = 1  # ways to shard samples-per-pixel

    @property
    def num_devices(self) -> int:
        return self.tile_axis * self.sample_axis


def check_finite(out, what: str = "output"):
    """Raise FloatingPointError if a floating tensor in ``out`` (a tensor
    or a tuple, list or dict of them) holds a NaN or an Inf; returns
    ``out``."""
    if isinstance(out, dict):
        items = out.values()
    elif isinstance(out, (tuple, list)):
        items = out
    else:
        items = (out,)
    for x in items:
        if isinstance(x, (tuple, list, dict)):
            check_finite(x, what)
        elif isinstance(x, torch.Tensor) and x.is_floating_point() and not bool(
                torch.isfinite(x).all()):
            raise FloatingPointError(f"non-finite values (NaN or Inf) in {what}")
    return out


def checked(fn):
    """Wrap ``fn`` so that a NaN or Inf in its floating outputs raises
    FloatingPointError (the counterpart of JAX's ``checkify`` float
    checks, tested on the outputs):

        img, rays = checked(render_fn)(scene, t)
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return check_finite(fn(*args, **kwargs), getattr(fn, "__name__", "output"))

    return wrapper
