"""Carry state from the JAX package into this one.

The JAX package's scenes and cameras are pytrees of arrays; handed over as
numpy arrays (``np.asarray(field)``), these functions rebuild them as this
package's containers, so both packages render the identical scene through
the identical camera. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.pinhole import Camera
from .render.integrator import SphereScene


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def sphere_scene_from_numpy(centers, radii, mat_kind, albedo, mat_param, device=None) -> SphereScene:
    """SphereScene from the five per-sphere arrays ([S,3], [S], [S], [S,3], [S])."""
    kind = torch.from_numpy(np.array(mat_kind, dtype=np.int32, copy=True)).to(device)
    scene = SphereScene(
        centers=_f32(centers, device),
        radii=_f32(radii, device),
        mat_kind=kind,
        albedo=_f32(albedo, device),
        mat_param=_f32(mat_param, device),
    )
    s = scene.num_spheres
    shapes = [tuple(x.shape) for x in (scene.centers, scene.radii, kind, scene.albedo, scene.mat_param)]
    if shapes != [(s, 3), (s,), (s,), (s, 3), (s,)]:
        raise ValueError(f"inconsistent sphere arrays: {shapes}")
    return scene


def camera_from_numpy(origin, lower_left, horizontal, vertical, u, v, lens_radius, device=None) -> Camera:
    """Camera from the JAX ``Camera`` fields (six [3] vectors and a scalar)."""
    return Camera(
        origin=_f32(origin, device),
        lower_left=_f32(lower_left, device),
        horizontal=_f32(horizontal, device),
        vertical=_f32(vertical, device),
        u=_f32(u, device),
        v=_f32(v, device),
        lens_radius=_f32(lens_radius, device).reshape(()),
    )
