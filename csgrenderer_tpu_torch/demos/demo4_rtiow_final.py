"""Config 4: the RTIOW final scene at 1080p, the main path's content.

Twin of ``demos/demo4_rtiow_final.py``. On the card each frame is one
launch of the sphere kernel (grid mode: ~480 spheres) over the scene packed
once; on the CPU the plain version runs. Each frame renders ``--spp``
samples at sample offset ``frame * spp`` through the thin lens; the
report line's times are the render's alone (synchronised), the nvcc build
excluded.

    python -m csgrenderer_tpu_torch.demos.demo4_rtiow_final --width 1920 --height 1080 --spp 64
"""

from __future__ import annotations

import time

from ._common import demo_argparser, device_of, how, png_sink, prebuild, render_only


def main(argv=None) -> None:
    args = demo_argparser("RTIOW final scene", width=1920, height=1080, spp=64,
                          bounces=8).parse_args(argv)
    device = device_of(args)

    from ..app.stats import FrameStats
    from ..camera import Camera
    from ..kernels import megakernel
    from ..models import rtiow_final_scene
    from ..render import tonemap

    packed = megakernel.pack_scene(rtiow_final_scene(device=device))
    camera = Camera.look_at(
        (13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=args.width / args.height,
        aperture=0.1, focus_dist=10.0, device=device,
    )
    build_s = prebuild(device, megakernel.KERNEL_SOURCE)
    sink = png_sink(args.out, "rtiow")
    stats = FrameStats()
    for i in range(args.frames):
        t0 = time.perf_counter()
        radiance, rays = megakernel.render_image_kernel(
            packed, camera, args.width, args.height, spp=args.spp, max_bounces=args.bounces,
            seed=args.seed, lens=True, sample_offset=i * args.spp,
        )
        n_rays = int(rays)  # waits for the frame
        stats.push(time.perf_counter() - t0, rays=n_rays)
        sink(i, tonemap.to_uint8(tonemap.tonemap(radiance)))
    print(f"[csgr] demo4: {packed.scene.num_spheres} spheres via "
          f"{how(device, f'sphere_megakernel[{packed.mode}]')}; {render_only(device, build_s)}",
          flush=True)
    print(stats.report_line(stats.dt_sum), flush=True)


if __name__ == "__main__":
    main()
