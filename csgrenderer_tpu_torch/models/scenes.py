"""Built-in sphere scenes.

Twin of ``csgrenderer_tpu/models/scenes.py`` (sphere families). Scenes
are built host-side with numpy, from the same ``np.random.default_rng``
calls in the same order as the JAX package, so the arrays are
byte-identical; they then become tensors on ``device``.

The CSG, night and mesh families wait for their ports (ROADMAP A5-A7).
"""

from __future__ import annotations

import numpy as np

from ..convert import sphere_scene_from_numpy
from ..render.integrator import SphereScene


def two_spheres_scene(device=None) -> SphereScene:
    """Config 2: one diffuse sphere resting on a diffuse 'ground plane'
    (RTIOW's giant-sphere ground)."""
    centers = np.array([[0.0, 0.0, -1.0], [0.0, -1000.5, -1.0]], np.float32)
    radii = np.array([0.5, 1000.0], np.float32)
    mat_kind = np.array([1, 1], np.int32)  # lambertian
    albedo = np.array([[0.7, 0.3, 0.3], [0.8, 0.8, 0.0]], np.float32)
    mat_param = np.zeros(2, np.float32)
    return sphere_scene_from_numpy(centers, radii, mat_kind, albedo, mat_param, device)


def rtiow_final_scene(seed: int = 42, grid: int = 11, device=None) -> SphereScene:
    """Config 4: the RTIOW final scene (the book's cover).

    ``grid=11`` gives the book's 22x22 candidate lattice (~480 small
    spheres kept) + ground + 3 heroes.
    """
    rng = np.random.default_rng(seed)
    centers, radii, kinds, albedos, params = [], [], [], [], []

    def add(c, r, kind, alb, prm=0.0):
        centers.append(c)
        radii.append(r)
        kinds.append(kind)
        albedos.append(alb)
        params.append(prm)

    add([0.0, -1000.0, 0.0], 1000.0, 1, [0.5, 0.5, 0.5])  # ground

    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = rng.random()
            center = [a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()]
            if np.linalg.norm(np.array(center) - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:  # diffuse
                alb = (rng.random(3) * rng.random(3)).tolist()
                add(center, 0.2, 1, alb)
            elif choose < 0.95:  # metal
                alb = (0.5 + 0.5 * rng.random(3)).tolist()
                fuzz = 0.5 * rng.random()
                add(center, 0.2, 2, alb, fuzz)
            else:  # glass
                add(center, 0.2, 3, [1.0, 1.0, 1.0], 1.5)

    add([0.0, 1.0, 0.0], 1.0, 3, [1.0, 1.0, 1.0], 1.5)  # glass hero
    add([-4.0, 1.0, 0.0], 1.0, 1, [0.4, 0.2, 0.1])  # diffuse hero
    add([4.0, 1.0, 0.0], 1.0, 2, [0.7, 0.6, 0.5], 0.0)  # metal hero

    return sphere_scene_from_numpy(
        np.array(centers, np.float32),
        np.array(radii, np.float32),
        np.array(kinds, np.int32),
        np.array(albedos, np.float32),
        np.array(params, np.float32),
        device,
    )
