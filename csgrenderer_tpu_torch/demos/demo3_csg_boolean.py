"""Config 3: (sphere ∪ box) ∖ cylinder through the flattened CSG tape.

Twin of ``demos/demo3_csg_boolean.py``; on the card the frames go through
the tape kernel. ``--native`` builds the same scene through the C++ scene
core (``scene/native.py``) instead of the Python scene graph.

    python -m csgrenderer_tpu_torch.demos.demo3_csg_boolean --width 512 --height 512 --spp 16
"""

from __future__ import annotations

from ._common import demo_argparser, device_of, prebuild, run_demo


def native_tape(device=None):
    """The demo's scene built through the C++ scene core, compiled."""
    from ..scene import Material, NodeArgument
    from ..scene.native import NativeSceneGraph

    g = NativeSceneGraph(max_node_count=16)
    s = g.add_sphere_node(1.0, Material.lambertian((0.75, 0.25, 0.25)))
    b = g.add_box_node((0.8, 0.8, 0.8), Material.lambertian((0.25, 0.75, 0.25)))
    c = g.add_cylinder_node(0.55, 1.6, Material.lambertian((0.25, 0.25, 0.75)))
    u = g.add_union_of_node(
        NodeArgument(s, offset=(-0.3, 0.0, 0.0)),
        NodeArgument(b, offset=(0.5, 0.0, 0.0)),
    )
    root = g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    return g.compile(root, device=device)


def main(argv=None) -> None:
    ap = demo_argparser("CSG boolean scene", width=512, height=512, spp=16, bounces=6)
    ap.add_argument("--native", action="store_true",
                    help="build the scene through the C++ scene core")
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..app import PathTraceRenderer
    from ..camera import Camera
    from ..kernels import tape_kernel
    from ..utils.config import RenderConfig

    if args.native:
        tape = native_tape(device)
    else:
        from ..models import config3_csg_scene

        tape = config3_csg_scene().compile(device=device)

    camera = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0,
                            aspect_ratio=args.width / args.height, device=device)
    renderer = PathTraceRenderer(
        tape,
        camera,
        RenderConfig(width=args.width, height=args.height, spp=args.spp,
                     max_bounces=args.bounces, seed=args.seed),
        device=device,
    )
    prebuild(device, tape_kernel.KERNEL_SOURCE)
    run_demo(renderer, args, "csg")


if __name__ == "__main__":
    main()
