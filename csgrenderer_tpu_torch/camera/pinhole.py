"""Cameras: the reference's fixed pinhole and the RTIOW thin lens.

Twin of ``csgrenderer_tpu/camera/pinhole.py``.

``WololoCamera`` and ``pixel_st_grid`` reproduce the reference shader's
ray generation (``ubershader1.frag:19-82``): st coordinates of pixel
centres with the y-flip (row 0 is the top row, st.y near 1), a viewport of
height 1 and width ``aspect``, focal length 1, the eye at the origin, and
directions left unnormalised, as the shader's sphere test and normal
consume them.

``Camera`` is the RTIOW camera of the path-traced configs: directions are
left unnormalised (the RTIOW convention) and ``rays`` takes optional
unit-disk samples for defocus blur.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
from torch import Tensor

from ..math import vec


def pixel_st_grid(width: int, height: int, device=None) -> tuple[Tensor, Tensor]:
    """The reference's st coordinates per pixel centre, [height, width]
    each; row 0 is the top image row (st.y = 1 - (y + 0.5) / H)."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    return xs[None, :].expand(height, width), ys[:, None].expand(height, width)


@dataclass(frozen=True)
class WololoCamera:
    """The reference's hard-coded shader camera (frag:50-60)."""

    focal_length: Tensor  # [] scalar
    origin: Tensor  # [3]

    @staticmethod
    def create(focal_length: float = 1.0, device=None) -> "WololoCamera":
        return WololoCamera(
            focal_length=torch.full((), focal_length, dtype=torch.float32, device=device),
            origin=torch.zeros((3,), dtype=torch.float32, device=device),
        )

    def rays(self, st_x: Tensor, st_y: Tensor, aspect_ratio) -> tuple[Tensor, Tensor]:
        """(origins, directions) for st coords; directions unnormalised."""
        f32 = dict(dtype=torch.float32, device=self.origin.device)
        aspect = torch.full((), aspect_ratio, **f32)
        zero, one = torch.zeros((), **f32), torch.ones((), **f32)
        horizontal = torch.stack([aspect, zero, zero])
        vertical = torch.stack([zero, one, zero])
        lower_left = (self.origin - horizontal / 2.0 - vertical / 2.0
                      - torch.stack([zero, zero, self.focal_length]))
        d = (lower_left + st_x[..., None] * horizontal + st_y[..., None] * vertical
             - self.origin)
        return self.origin.expand(d.shape), d


@dataclass(frozen=True)
class Camera:
    """RTIOW thin-lens camera; build with ``Camera.look_at``."""

    origin: Tensor  # [3]
    lower_left: Tensor  # [3]
    horizontal: Tensor  # [3] full viewport width vector
    vertical: Tensor  # [3] full viewport height vector
    u: Tensor  # [3] camera basis (right)
    v: Tensor  # [3] camera basis (up)
    lens_radius: Tensor  # [] scalar

    @staticmethod
    def look_at(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov_degrees: float = 40.0,
        aspect_ratio: float = 16.0 / 9.0,
        aperture: float = 0.0,
        focus_dist: float | None = None,
        device=None,
    ) -> "Camera":
        f32 = dict(dtype=torch.float32, device=device)
        lookfrom = torch.as_tensor(lookfrom, **f32)
        lookat = torch.as_tensor(lookat, **f32)
        vup = torch.as_tensor(vup, **f32)
        if focus_dist is None:
            focus_dist = vec.length(lookfrom - lookat)
        focus_dist = torch.as_tensor(focus_dist, **f32)

        theta = torch.as_tensor(vfov_degrees, **f32) * (math.pi / 180.0)
        h = torch.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = aspect_ratio * viewport_height

        w = vec.normalized(lookfrom - lookat)
        u = vec.normalized(vec.cross(vup, w))
        v = vec.cross(w, u)

        horizontal = focus_dist * viewport_width * u
        vertical = focus_dist * viewport_height * v
        lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
        return Camera(
            origin=lookfrom,
            lower_left=lower_left,
            horizontal=horizontal,
            vertical=vertical,
            u=u,
            v=v,
            lens_radius=torch.as_tensor(aperture, **f32) / 2.0,
        )

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def rays(
        self, st_x: Tensor, st_y: Tensor, lens_uv: Tensor | None = None
    ) -> tuple[Tensor, Tensor]:
        """(origins, directions); directions unnormalised (RTIOW convention).

        ``lens_uv``: optional [..., 2] unit-disk samples for defocus blur;
        omit for a pure pinhole.
        """
        if lens_uv is None:
            offset = torch.zeros(st_x.shape + (3,), dtype=st_x.dtype, device=st_x.device)
        else:
            rd = self.lens_radius * lens_uv
            offset = rd[..., 0:1] * self.u + rd[..., 1:2] * self.v
        o = self.origin + offset
        d = (
            self.lower_left
            + st_x[..., None] * self.horizontal
            + st_y[..., None] * self.vertical
            - self.origin
            - offset
        )
        return o, d
