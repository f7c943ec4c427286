from .scenes import (
    animated_csg_scene,
    config3_csg_scene,
    csg_night_scene,
    many_objects_scene,
    milestone01_scene_graph,
    night_scene,
    rtiow_final_scene,
    two_spheres_scene,
)

__all__ = [
    "animated_csg_scene",
    "config3_csg_scene",
    "csg_night_scene",
    "many_objects_scene",
    "milestone01_scene_graph",
    "night_scene",
    "rtiow_final_scene",
    "two_spheres_scene",
]
