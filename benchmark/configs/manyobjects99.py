"""The many-objects scene at 99 objects: the program's build and the plain
reference's.

99 small CSG solids (a bitten sphere, a lens, a ring and a box with a
sphere cap, in turn) on a jittered 10 x 10 grid, unioned one after another
onto a half-space ground: 199 leaves. The configuration file lists each
object's shape, centre, scale, albedo and metal fuzz (the draws
``models.many_objects_scene(99)`` makes from seed 13) and each shape's two
leaves in units of the object's scale. The program builds the graph from
that list through ``SceneGraph``, as ``many_objects_scene`` does, and
compiles it with the file's ``k``; the reference builds its leaves from the
same list (``benchmark/reference/solids.py``).
"""

from __future__ import annotations

LEAF_TYPES = ("sphere", "halfspace", "box", "cylinder")


def _graph(scene: dict):
    from csgrenderer_tpu_torch.scene import Material, NodeArgument, SceneGraph

    g = SceneGraph(max_node_count=16 * len(scene["objects"]) + 8, name="many-objects")

    def material(leaf: dict, obj: dict) -> Material:
        albedo = leaf.get("albedo", obj["albedo"])
        if leaf["material"] == "metal":
            return Material.metal(albedo, obj["fuzz"])
        return Material.lambertian(albedo)

    add = {"sphere": lambda size, m: g.add_sphere_node(size[0], m),
           "box": lambda size, m: g.add_box_node(size, m),
           "cylinder": lambda size, m: g.add_cylinder_node(size[0], size[1], m)}
    join = {"union": g.add_union_of_node, "intersection": g.add_intersection_of_node,
            "difference": g.add_difference_of_node}
    root = None
    for obj in scene["objects"]:
        shape = scene["shapes"][obj["shape"]]
        (cx, cz), s = obj["centre"], obj["scale"]
        args = [NodeArgument(add[leaf["type"]]([v * s for v in leaf["size"]],
                                               material(leaf, obj)),
                             offset=(cx + leaf["at"][0] * s, leaf["at"][1] * s,
                                     cz + leaf["at"][2] * s))
                for leaf in shape["leaves"]]
        node = join[shape["op"]](*args)
        root = node if root is None else g.add_union_of_node(NodeArgument(root),
                                                             NodeArgument(node))
    ground = scene["ground"]
    floor = g.add_infinite_planar_partition_node(ground["normal"],
                                                 Material.lambertian(ground["albedo"]))
    g.add_union_of_node(NodeArgument(root), NodeArgument(floor))
    return g


def program_scene(cfg: dict, device, animated: bool, t: float):
    """(tape, animate): the scene compiled once; it does not animate."""
    if animated:
        raise ValueError("the many-objects scene does not animate")
    s = cfg["scene"]
    tape = _graph(s).compile(k=s["k"], device=device)
    if tape.n_leaves != s["leaves"]:
        raise ValueError(f"the scene has {tape.n_leaves} leaves, the configuration {s['leaves']}")
    return tape, None


def reference_scene(cfg: dict, device, dtype, t: float):
    """The reference's leaves, static (``t`` is ignored)."""
    from benchmark.reference.solids import Solids

    solids = Solids.build(cfg["scene"], dtype, device)
    if solids.num_leaves != cfg["scene"]["leaves"]:
        raise ValueError(f"the scene has {solids.num_leaves} leaves, the configuration "
                         f"{cfg['scene']['leaves']}")
    return solids


def work(cfg: dict) -> dict:
    """What a roofline floor reads of the configuration: the leaves, the
    objects and the leaf types present."""
    s = cfg["scene"]
    kinds = {leaf["type"] for obj in s["objects"] for leaf in s["shapes"][obj["shape"]]["leaves"]}
    kinds.add(s["ground"]["type"])
    return {"leaves": sum(len(s["shapes"][obj["shape"]]["leaves"]) for obj in s["objects"]) + 1,
            "objects": len(s["objects"]), "leaf_types": sorted(kinds, key=LEAF_TYPES.index)}
