"""Config 2: two spheres and a ground, Lambertian, 8-bounce path trace.

Twin of ``demos/demo2_diffuse_spheres.py``; on the card the frames go
through the sphere kernel (brute mode: two spheres).

    python -m csgrenderer_tpu_torch.demos.demo2_diffuse_spheres --width 800 --height 450 --spp 16
"""

from __future__ import annotations

from ._common import demo_argparser, device_of, prebuild, run_demo


def main(argv=None) -> None:
    args = demo_argparser(
        "diffuse two-sphere path trace", width=800, height=450, spp=16, bounces=8
    ).parse_args(argv)
    device = device_of(args)

    from ..app import PathTraceRenderer
    from ..camera import Camera
    from ..kernels import megakernel
    from ..models import two_spheres_scene
    from ..utils.config import RenderConfig

    camera = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                            aspect_ratio=args.width / args.height, device=device)
    renderer = PathTraceRenderer(
        two_spheres_scene(device=device),
        camera,
        RenderConfig(width=args.width, height=args.height, spp=args.spp,
                     max_bounces=args.bounces, seed=args.seed),
        device=device,
    )
    prebuild(device, megakernel.KERNEL_SOURCE)
    run_demo(renderer, args, "diffuse")


if __name__ == "__main__":
    main()
