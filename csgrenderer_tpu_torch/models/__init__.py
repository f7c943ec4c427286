from .scenes import rtiow_final_scene, two_spheres_scene

__all__ = ["rtiow_final_scene", "two_spheres_scene"]
