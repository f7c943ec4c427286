"""Demo 7's icosphere scene at 102,402 faces: the program's build and the
plain reference's.

A metal, a glass and three Lambertian icospheres (``subdiv`` levels of
midpoint subdivision, 20 x 4**subdiv faces each) on a floor quad of two
faces, in the configuration file's order; 5 x 20,480 + 2 = 102,402 faces at
subdivision 5. The program builds it with ``models.mesh_demo_scene``, the
reference from the file's centres, radii, materials and corners
(``benchmark/reference/mesh.py``).
"""

from __future__ import annotations


def program_scene(cfg: dict, device, animated: bool, t: float):
    """(scene, animate) as the program builds them; the scene is static."""
    from csgrenderer_tpu_torch.models import mesh_demo_scene

    if animated:
        raise ValueError("the mesh scene does not animate")
    s = cfg["scene"]
    return mesh_demo_scene(subdiv=s["subdiv"], spheres=len(s["spheres"]), device=device), None


def reference_scene(cfg: dict, device, dtype, t: float):
    """The reference's scene, static (``t`` is ignored)."""
    from benchmark.reference.mesh import MeshSoup, parts_of

    soup = MeshSoup.build(parts_of(cfg["scene"]), dtype=dtype, device=device)
    if soup.num_faces != cfg["scene"]["faces"]:
        raise ValueError(f"the scene has {soup.num_faces} faces, the configuration "
                         f"{cfg['scene']['faces']}")
    return soup


def work(cfg: dict) -> dict:
    """What a roofline floor reads of the configuration: the faces, the
    objects (icospheres and the floor) and the floor's two faces, which
    every ray tests."""
    s = cfg["scene"]
    return {"faces": len(s["spheres"]) * 20 * 4 ** s["subdiv"] + 2,
            "objects": len(s["spheres"]) + 1, "global_faces": 2}
