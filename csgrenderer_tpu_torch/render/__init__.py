from . import integrator, intersect, materials, sampling, tonemap
from .integrator import SphereScene, SurfaceHit, render_image, render_tile, sky_color, trace_paths

__all__ = [
    "integrator",
    "intersect",
    "materials",
    "sampling",
    "tonemap",
    "SphereScene",
    "SurfaceHit",
    "render_image",
    "render_tile",
    "sky_color",
    "trace_paths",
]
