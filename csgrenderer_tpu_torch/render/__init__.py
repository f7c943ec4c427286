from . import (
    aov,
    denoise,
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
from .aov import AOVs, render_aovs
from .denoise import atrous_denoise, denoise_frame
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
    "aov",
    "denoise",
    "integrator",
    "intersect",
    "interval",
    "lights",
    "materials",
    "sampling",
    "tape_eval",
    "tonemap",
    "trimesh",
    "AOVs",
    "render_aovs",
    "atrous_denoise",
    "denoise_frame",
    "SphereScene",
    "SurfaceHit",
    "render_image",
    "render_tile",
    "sky_color",
    "tape_hit_adapter",
    "trace_paths",
]
