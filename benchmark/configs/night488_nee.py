"""The lamp-lit night scene: the program's build and the plain reference's.

The RTIOW cover lattice under a black sky, lit by two emissive sphere
lamps. The small spheres are drawn on a 2*grid x 2*grid lattice by
``numpy.random.default_rng(seed)``: per cell one uniform picks the
material (the configuration's shares: Lambertian, metal, glass), two
place the centre in the cell (no cell is left empty); a Lambertian albedo
is the product of two uniform triples, a metal's 0.5 + 0.5 u with fuzz
``metal_fuzz`` u, a glass sphere's index ``index``. Then come the lamps
(material kind 4, the emission as their colour) and the heroes, in the
file's order, after the ground and the lattice.
"""

from __future__ import annotations

import numpy as np

KINDS = {"lambertian": 1, "metal": 2, "dielectric": 3}
EMISSIVE = 4


def program_scene(cfg: dict, device, animated: bool, t: float):
    """(scene, animate) as the program builds them; the scene is static."""
    from csgrenderer_tpu_torch.models import night_scene

    if animated:
        raise ValueError("the night scene does not animate")
    s = cfg["scene"]
    return night_scene(seed=s["seed"], grid=s["grid"], device=device), None


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
    lat, r_small = s["lattice"], s["small_radius"]
    for a in range(-s["grid"], s["grid"]):
        for b in range(-s["grid"], s["grid"]):
            choose = rng.random()
            center = [a + 0.9 * rng.random(), r_small, b + 0.9 * rng.random()]
            if choose < lat["lambertian"]:
                add(center, r_small, 1, (rng.random(3) * rng.random(3)).tolist())
            elif choose < lat["lambertian"] + lat["metal"]:
                alb = (0.5 + 0.5 * rng.random(3)).tolist()
                add(center, r_small, 2, alb, lat["metal_fuzz"] * rng.random())
            else:
                add(center, r_small, 3, [1.0, 1.0, 1.0], lat["index"])
    for lamp in s["lamps"]:
        add(lamp["center"], lamp["radius"], EMISSIVE, lamp["emission"])
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
    """What a roofline floor reads of the configuration: the spheres, and
    the lamps among them."""
    return {"primitives": cfg["scene"]["spheres"], "lamps": len(cfg["scene"]["lamps"])}
