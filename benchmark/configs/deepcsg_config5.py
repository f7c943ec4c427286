"""The deep CSG chain of BASELINE config 5: the program's build and the
plain reference's.

A chain of ``levels`` sphere leaves, (((s0 op1 s1) op2 s2) ...), each
child offset along x in its parent's frame; every edge of the tree rotates
about y at its own rate, and the frame is taken at the frozen time t of
the traffic mix. The reference reads radii, offsets, operations, albedos
and edge rates from the configuration file; the program builds the same
tree with ``animated_csg_scene``.
"""

from __future__ import annotations


def program_scene(cfg: dict, device, animated: bool, t: float):
    """(scene, animate): with ``animated`` the renderer animates the tape
    to each frame's time (and reclusters it); without, the tape is baked
    at ``t`` once."""
    from csgrenderer_tpu_torch.models import animated_csg_scene

    s = cfg["scene"]
    graph, animate = animated_csg_scene(n_levels=s["levels"])
    tape = graph.compile(k=s["k"], device=device)
    if animated:
        return tape, animate
    return animate(tape, t), None


def reference_scene(cfg: dict, device, dtype, t: float):
    from benchmark.reference.csg import deep_chain

    s = cfg["scene"]
    return deep_chain(s["levels"], s["radii"], s["offsets"], s["ops"], s["albedo"],
                      tuple(s["edge_rate"]), t, dtype, device)


def work(cfg: dict) -> dict:
    """What a roofline floor reads of the configuration: its sphere leaves."""
    return {"primitives": cfg["scene"]["leaves"]}
