"""Built-in scenes: sphere soups and CSG scene graphs.

Twin of ``csgrenderer_tpu/models/scenes.py`` (sphere and CSG families).
Scenes are built host-side with numpy, from the same
``np.random.default_rng`` calls in the same order as the JAX package, so
the arrays are byte-identical; sphere scenes then become tensors on
``device``. The CSG builders return a ``SceneGraph``, whose
``compile(k=..., device=...)`` makes the tape.

The night scenes (black sky, emissive sphere or face lamps) are the
showcases of next-event estimation. The mesh scenes return a
``MeshScene`` on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import sphere_scene_from_numpy
from ..math import quaternion as quat
from ..render.integrator import SphereScene
from ..render.trimesh import MeshScene, concat_meshes, icosphere, quad
from ..scene.graph import Material, NodeArgument, SceneGraph


def milestone01_scene_graph() -> SceneGraph:
    """The reference demo's scene-graph build: two unit spheres and their
    union (``src/wololo_demo/main.c:40-45``)."""
    g = SceneGraph(max_node_count=8, name="Test1Render")
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    g.add_union_of_node(NodeArgument(s1), NodeArgument(s2))
    return g


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


def night_scene(seed: int = 7, grid: int = 6, device=None) -> SphereScene:
    """Emissive-lit variant of the RTIOW lattice: black sky, two sphere
    lamps over a field of diffuse, metal and glass spheres (148 spheres at
    ``grid=6``, 488 at ``grid=11``). Without NEE a path finds the lamps
    only by chance."""
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
            if choose < 0.7:  # diffuse
                alb = (rng.random(3) * rng.random(3)).tolist()
                add(center, 0.2, 1, alb)
            elif choose < 0.9:  # metal
                alb = (0.5 + 0.5 * rng.random(3)).tolist()
                add(center, 0.2, 2, alb, 0.4 * rng.random())
            else:  # glass
                add(center, 0.2, 3, [1.0, 1.0, 1.0], 1.5)

    # lamps: a warm key light and a cool fill
    add([2.0, 2.6, 1.0], 0.6, 4, [14.0, 11.0, 7.0])
    add([-3.0, 1.6, -2.0], 0.35, 4, [3.0, 5.0, 9.0])
    add([0.0, 0.9, 0.0], 0.9, 2, [0.8, 0.8, 0.9], 0.05)  # metal hero

    return sphere_scene_from_numpy(
        np.array(centers, np.float32),
        np.array(radii, np.float32),
        np.array(kinds, np.int32),
        np.array(albedos, np.float32),
        np.array(params, np.float32),
        device,
    )


def config3_csg_scene() -> SceneGraph:
    """Config 3: (sphere ∪ box) ∖ cylinder with distinct diffuse materials."""
    g = SceneGraph(max_node_count=16, name="csg-boolean")
    s = g.add_sphere_node(1.0, Material.lambertian((0.75, 0.25, 0.25)))
    b = g.add_box_node((0.8, 0.8, 0.8), Material.lambertian((0.25, 0.75, 0.25)))
    c = g.add_cylinder_node(0.55, 1.6, Material.lambertian((0.25, 0.25, 0.75)))
    u = g.add_union_of_node(
        NodeArgument(s, offset=(-0.3, 0.0, 0.0)),
        NodeArgument(b, offset=(0.5, 0.0, 0.0)),
    )
    g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    return g


def csg_night_scene() -> SceneGraph:
    """Night scene of CSG solids (compile with k >= 4): black sky, two
    emissive sphere LEAVES as lamps, and a bitten sphere (sphere minus a
    rotated box), a glass lens (sphere intersection) and a metal ring
    (cylinder minus cylinder), all unioned with an infinite ground plane."""
    g = SceneGraph(max_node_count=32, name="csg-night")

    ground = g.add_infinite_planar_partition_node((0, 1, 0), Material.lambertian((0.45, 0.45, 0.48)))

    # bitten sphere: diffuse sphere minus a rotated box
    s = g.add_sphere_node(1.0, Material.lambertian((0.75, 0.3, 0.25)))
    bite = g.add_box_node((0.65, 0.65, 0.65), Material.lambertian((0.9, 0.75, 0.3)))
    rot = tuple(float(x) for x in quat.from_axis_angle([0.0, 1.0, 0.0], 0.6))
    bitten = g.add_difference_of_node(
        NodeArgument(s, offset=(-1.6, 1.0, -0.2)),
        NodeArgument(bite, orientation=rot, offset=(-0.9, 1.7, 0.2)),
    )

    # glass lens: intersection of two offset spheres
    l1 = g.add_sphere_node(0.9, Material.dielectric(1.5))
    l2 = g.add_sphere_node(0.9, Material.dielectric(1.5))
    lens = g.add_intersection_of_node(
        NodeArgument(l1, offset=(1.4, 0.75, 0.75)),
        NodeArgument(l2, offset=(1.4, 0.75, -0.35)),
    )

    # metal ring: cylinder minus a thinner cylinder
    c_out = g.add_cylinder_node(0.8, 0.22, Material.metal((0.85, 0.8, 0.6), 0.08))
    c_in = g.add_cylinder_node(0.55, 0.3, Material.metal((0.85, 0.8, 0.6), 0.08))
    ring = g.add_difference_of_node(
        NodeArgument(c_out, offset=(0.1, 0.22, 1.9)),
        NodeArgument(c_in, offset=(0.1, 0.22, 1.9)),
    )

    # lamps: emissive sphere leaves riding the tape (lights.extract_tape_lights)
    key = g.add_sphere_node(0.5, Material.emissive((13.0, 10.5, 7.0)))
    fill = g.add_sphere_node(0.3, Material.emissive((2.5, 4.5, 8.5)))

    node = g.add_union_of_node(NodeArgument(bitten), NodeArgument(lens))
    node = g.add_union_of_node(NodeArgument(node), NodeArgument(ring))
    node = g.add_union_of_node(NodeArgument(node), NodeArgument(key, offset=(1.2, 2.9, 0.6)))
    node = g.add_union_of_node(NodeArgument(node), NodeArgument(fill, offset=(-2.8, 1.5, 1.8)))
    g.add_union_of_node(NodeArgument(node), NodeArgument(ground))
    return g


def many_objects_scene(n_objects: int = 33, seed: int = 13, ground: bool = True) -> SceneGraph:
    """A union of many small disjoint CSG solids on a ground plane, the
    showcase of the disjoint-cluster decomposition (``scene/partition.py``):
    about 3 leaves per object, on a jittered grid whose spacing keeps the
    objects' bounds apart. Shapes cycle: bitten sphere, lens, ring, box with
    a sphere cap."""
    rng = np.random.default_rng(seed)
    g = SceneGraph(max_node_count=16 * n_objects + 8, name="many-objects")
    palette = [
        (0.8, 0.35, 0.3), (0.3, 0.7, 0.4), (0.35, 0.45, 0.85),
        (0.85, 0.75, 0.35), (0.7, 0.4, 0.8), (0.4, 0.75, 0.75),
    ]

    side = int(np.ceil(np.sqrt(n_objects)))
    spacing = 2.4  # objects fit in a ~1.0-radius ball: bounds stay disjoint
    roots = []
    for k in range(n_objects):
        gx = (k % side - (side - 1) / 2.0) * spacing
        gz = (k // side - (side - 1) / 2.0) * spacing
        cx = gx + float(rng.uniform(-0.25, 0.25))
        cz = gz + float(rng.uniform(-0.25, 0.25))
        alb = palette[k % len(palette)]
        kind = k % 4
        s = float(rng.uniform(0.75, 1.0))  # object scale
        if kind == 0:  # bitten sphere
            a = g.add_sphere_node(0.55 * s, Material.lambertian(alb))
            b = g.add_box_node((0.4 * s,) * 3, Material.metal((0.8, 0.8, 0.85), 0.1))
            node = g.add_difference_of_node(
                NodeArgument(a, offset=(cx, 0.55 * s, cz)),
                NodeArgument(b, offset=(cx + 0.3 * s, 0.85 * s, cz)),
            )
        elif kind == 1:  # lens (sphere intersection), resting above ground
            a = g.add_sphere_node(0.6 * s, Material.lambertian(alb))
            b = g.add_sphere_node(0.6 * s, Material.lambertian(alb))
            node = g.add_intersection_of_node(
                NodeArgument(a, offset=(cx, 0.62 * s, cz - 0.3 * s)),
                NodeArgument(b, offset=(cx, 0.62 * s, cz + 0.3 * s)),
            )
        elif kind == 2:  # ring (cylinder difference)
            a = g.add_cylinder_node(0.55 * s, 0.18 * s, Material.lambertian(alb))
            b = g.add_cylinder_node(0.38 * s, 0.3 * s, Material.lambertian(alb))
            node = g.add_difference_of_node(
                NodeArgument(a, offset=(cx, 0.18 * s, cz)),
                NodeArgument(b, offset=(cx, 0.18 * s, cz)),
            )
        else:  # box with a sphere cap
            a = g.add_box_node((0.4 * s, 0.3 * s, 0.4 * s), Material.lambertian(alb))
            b = g.add_sphere_node(0.35 * s, Material.metal(alb, 0.2))
            node = g.add_union_of_node(
                NodeArgument(a, offset=(cx, 0.3 * s, cz)),
                NodeArgument(b, offset=(cx, 0.75 * s, cz)),
            )
        roots.append(node)

    node = roots[0]
    for r in roots[1:]:
        node = g.add_union_of_node(NodeArgument(node), NodeArgument(r))
    if ground:
        gr = g.add_infinite_planar_partition_node((0, 1, 0), Material.lambertian((0.5, 0.5, 0.52)))
        g.add_union_of_node(NodeArgument(node), NodeArgument(gr))
    return g


def animated_csg_scene(n_levels: int = 8):
    """Config 5: a depth-``n_levels`` CSG chain whose edges animate over time.

    Returns (graph, animate) where ``animate(tape, t) -> tape`` rotates each
    edge about the y axis at its own rate (``tape.with_edges``). The chain
    is (((sphere ∪ s1) ∖ s2) ∪ s3) ..., a difference at every third level,
    each child orbiting its parent.
    """
    g = SceneGraph(max_node_count=64, name="animated-deep-csg")
    palette = [
        (0.9, 0.3, 0.3), (0.3, 0.9, 0.3), (0.3, 0.3, 0.9), (0.9, 0.9, 0.3),
        (0.9, 0.3, 0.9), (0.3, 0.9, 0.9), (0.8, 0.5, 0.2), (0.6, 0.6, 0.9),
    ]
    node = g.add_sphere_node(1.0, Material.lambertian(palette[0]))
    for level in range(1, n_levels):
        child = g.add_sphere_node(0.3 + 0.4 / level, Material.lambertian(palette[level % len(palette)]))
        arg_parent = NodeArgument(node)
        arg_child = NodeArgument(child, offset=(1.0 + 0.15 * level, 0.0, 0.0))
        if level % 3 == 2:
            node = g.add_difference_of_node(arg_parent, arg_child)
        else:
            node = g.add_union_of_node(arg_parent, arg_child)

    def animate(tape, t):
        """Orbit each edge's child about the y axis at its own rate."""
        dev = tape.device
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        e = tape.edge_quat.shape[0]
        idx = torch.arange(e, dtype=torch.float32, device=dev)
        angles = t * (0.3 + 0.15 * idx)
        axis = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float32, device=dev).expand(e, 3)
        return tape.with_edges(quat.from_axis_angle(axis, angles), tape.edge_off)

    return g, animate


def mesh_night_scene(subdiv: int = 2, device=None) -> MeshScene:
    """Emissive-quad-lit triangle-mesh night scene: two quad panel lamps
    over Lambertian and glossy-metal icospheres and a floor, black sky
    (966 faces at ``subdiv=2``, four of them lamps); the mesh twin of
    ``night_scene`` / ``csg_night_scene``."""
    return concat_meshes(
        icosphere((-1.2, 0.75, -3.1), 0.75, Material.lambertian((0.65, 0.3, 0.25)), subdiv, device),
        icosphere((1.1, 0.7, -2.8), 0.7, Material.metal((0.85, 0.75, 0.55), 0.15), subdiv, device),
        icosphere((-0.1, 0.42, -1.8), 0.42, Material.lambertian((0.25, 0.4, 0.7)), subdiv, device),
        quad((-1.4, 2.6, -3.6), (-0.2, 2.6, -3.6), (-0.2, 2.6, -2.4), (-1.4, 2.6, -2.4),
             Material.emissive((16.0, 14.0, 10.0)), device),
        quad((1.0, 2.2, -2.2), (2.0, 2.2, -2.2), (2.0, 2.2, -1.2), (1.0, 2.2, -1.2),
             Material.emissive((4.0, 7.0, 12.0)), device),
        quad((-7, 0, -10), (7, 0, -10), (7, 0, 2.5), (-7, 0, 2.5),
             Material.lambertian((0.5, 0.5, 0.48)), device),
    )


def mesh_demo_scene(subdiv: int = 2, spheres: int = 3, device=None) -> MeshScene:
    """The mesh demo scene (``demos/demo7_mesh.py::build_scene``, which
    ``tools/bench_mesh.py`` measures): a metal, a glass and a Lambertian
    icosphere on a floor quad; ``spheres`` > 3 appends Lambertian spheres
    behind them. Faces: 3 x 20 x 4**subdiv + 2 (15,362 at subdiv 4;
    102,402 with 5 spheres at subdiv 5)."""
    parts = [
        icosphere((-1.1, 0.8, -3.2), 0.8, Material.metal((0.9, 0.8, 0.6), 0.05), subdiv, device),
        icosphere((1.1, 0.8, -3.0), 0.8, Material.dielectric(1.5), subdiv, device),
        icosphere((0.0, 0.45, -1.9), 0.45, Material.lambertian((0.2, 0.35, 0.7)), subdiv, device),
    ]
    extra = [((-2.4, 0.7, -5.2), 0.7, (0.7, 0.3, 0.25)),
             ((2.4, 0.7, -5.4), 0.7, (0.3, 0.6, 0.3)),
             ((0.0, 0.9, -6.3), 0.9, (0.8, 0.7, 0.2)),
             ((-3.4, 0.5, -2.6), 0.5, (0.5, 0.4, 0.7))]
    for c, r, alb in extra[: max(0, spheres - 3)]:
        parts.append(icosphere(c, r, Material.lambertian(alb), subdiv, device))
    parts.append(quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2),
                      Material.lambertian((0.55, 0.55, 0.5)), device))
    return concat_meshes(*parts)
