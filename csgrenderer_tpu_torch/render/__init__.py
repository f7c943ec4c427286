from . import (
    integrator,
    intersect,
    interval,
    lights,
    materials,
    sampling,
    tape_eval,
    tonemap,
    trimesh,
)
from .integrator import (
    SphereScene,
    SurfaceHit,
    render_image,
    render_tile,
    sky_color,
    tape_hit_adapter,
    trace_paths,
)

__all__ = [
    "integrator",
    "intersect",
    "interval",
    "lights",
    "materials",
    "sampling",
    "tape_eval",
    "tonemap",
    "trimesh",
    "SphereScene",
    "SurfaceHit",
    "render_image",
    "render_tile",
    "sky_color",
    "tape_hit_adapter",
    "trace_paths",
]
