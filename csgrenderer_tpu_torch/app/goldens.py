"""The golden configs of ``tools/make_goldens.py`` through the port's renderers.

``golden_renderers(device)`` maps each golden's name (its file under
``tests/goldens/``) to a function that builds the renderer of that config
on ``device`` and returns it with the frame time to draw. The scenes,
cameras and ``RenderConfig``s are those of ``tools/make_goldens.py``,
which renders them with the JAX package's reference path.
"""

from __future__ import annotations

from ..camera import Camera
from ..models import (
    animated_csg_scene,
    config3_csg_scene,
    mesh_night_scene,
    rtiow_final_scene,
    two_spheres_scene,
)
from ..utils.config import RenderConfig
from .renderers import PathTraceRenderer, WololoRenderer


def golden_renderers(device="cuda") -> dict:
    """name -> () -> (renderer, time_sec)."""

    def look(eye, at, vfov, aspect, **kw):
        return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect, **kw)

    def config1():
        cfg = RenderConfig(width=320, height=240, spp=1, sky="wololo")
        return WololoRenderer(cfg, device=device), 0.25

    def config2():
        cfg = RenderConfig(width=200, height=112, spp=8, max_bounces=8, seed=2)
        cam = look((0, 0, 0), (0, 0, -1), 90.0, 200 / 112)
        return PathTraceRenderer(two_spheres_scene(), cam, cfg, device=device), 0.0

    def config3():
        cfg = RenderConfig(width=128, height=128, spp=8, max_bounces=6, seed=3)
        cam = look((3, 2.5, 4), (0.1, 0, 0), 35.0, 1.0)
        return PathTraceRenderer(config3_csg_scene().compile(), cam, cfg, device=device), 0.0

    def config4():
        cfg = RenderConfig(width=160, height=90, spp=4, max_bounces=8, seed=4, lens=True)
        cam = look((13, 2, 3), (0, 0, 0), 20.0, 160 / 90, aperture=0.1, focus_dist=10.0)
        return PathTraceRenderer(rtiow_final_scene(), cam, cfg, device=device), 0.0

    def config5():
        graph, animate = animated_csg_scene(n_levels=8)
        cfg = RenderConfig(width=128, height=128, spp=2, max_bounces=5, seed=5)
        cam = look((0, 2.0, 7.0), (0.5, 0, 0), 40.0, 1.0)
        return PathTraceRenderer(graph.compile(), cam, cfg, animate=animate, device=device), 1.0

    def config7():
        cfg = RenderConfig(width=160, height=90, spp=8, max_bounces=5, seed=7, sky="black",
                           nee=True)
        cam = look((0, 1.8, 2.4), (0, 0.7, -2.6), 45.0, 160 / 90)
        return PathTraceRenderer(mesh_night_scene(), cam, cfg, device=device), 0.0

    return {
        "config1_milestone01": config1,
        "config2_two_spheres": config2,
        "config3_csg_boolean": config3,
        "config4_rtiow_final": config4,
        "config5_animated_csg": config5,
        "config7_meshnight": config7,
    }
