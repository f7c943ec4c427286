"""The RTIOW final scene: the program's build and the plain reference's.

The small spheres of the book's cover are drawn on a 2*grid x 2*grid
lattice by ``numpy.random.default_rng(seed)``: per cell one uniform picks
the material (80% Lambertian, 15% metal, 5% glass), two place the centre
in the cell, and a cell whose centre lies within 0.9 of (4, 0.2, 0) is
left empty; a Lambertian albedo is the product of two uniform triples, a
metal's 0.5 + 0.5 u with fuzz 0.5 u. The ground and the three large
spheres come from the configuration file.
"""

from __future__ import annotations

import numpy as np

KINDS = {"lambertian": 1, "metal": 2, "dielectric": 3}


def program_scene(cfg: dict, device, animated: bool, t: float):
    """(scene, animate) as the program builds them; the scene is static."""
    from csgrenderer_tpu_torch.models import rtiow_final_scene

    if animated:
        raise ValueError("the RTIOW scene does not animate")
    s = cfg["scene"]
    return rtiow_final_scene(seed=s["seed"], grid=s["grid"], device=device), None


def sphere_lists(cfg: dict):
    """(centres, radii, kinds, albedos, params) as float64 host lists."""
    s = cfg["scene"]
    rng = np.random.default_rng(s["seed"])
    out = ([], [], [], [], [])

    def add(c, r, kind, alb, prm=0.0):
        for lst, v in zip(out, (list(c), r, kind, list(alb), prm)):
            lst.append(v)

    g = s["ground"]
    add(g["center"], g["radius"], 1, g["albedo"])
    r_small = s["small_radius"]
    for a in range(-s["grid"], s["grid"]):
        for b in range(-s["grid"], s["grid"]):
            choose = rng.random()
            center = [a + 0.9 * rng.random(), r_small, b + 0.9 * rng.random()]
            if np.linalg.norm(np.array(center) - np.array([4.0, r_small, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                add(center, r_small, 1, (rng.random(3) * rng.random(3)).tolist())
            elif choose < 0.95:
                alb = (0.5 + 0.5 * rng.random(3)).tolist()
                add(center, r_small, 2, alb, 0.5 * rng.random())
            else:
                add(center, r_small, 3, [1.0, 1.0, 1.0], 1.5)
    for h in s["heroes"]:
        kind = KINDS[h["kind"]]
        param = h.get("index", h.get("fuzz", 0.0))
        add(h["center"], h["radius"], kind, h.get("albedo", [1.0, 1.0, 1.0]), param)
    if len(out[0]) != s["spheres"]:
        raise ValueError(f"the scene has {len(out[0])} spheres, the configuration {s['spheres']}")
    return out


def reference_scene(cfg: dict, device, dtype, t: float):
    """The reference's scene, static (``t`` is ignored)."""
    from benchmark.reference.spheres import SphereSoup

    return SphereSoup.build(*sphere_lists(cfg), dtype=dtype, device=device)


def work(cfg: dict) -> dict:
    """What a roofline floor reads of the configuration."""
    return {"primitives": cfg["scene"]["spheres"]}
