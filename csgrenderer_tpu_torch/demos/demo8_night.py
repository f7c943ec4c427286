"""Demo 8: next-event estimation on an emissive-lit night scene.

Twin of ``demos/demo8_night.py``. The reference declares ``Wo_Material``
and never uses it (renderer.h:16); this renderer's material set includes
emissive spheres, and under a black sky lit by small lamps plain path
tracing finds the light only by chance. NEE (render/lights.py) samples
the lamps directly at every diffuse hit: the same expectation, a fraction
of the noise. On the card the frame is one launch of the sphere kernel
(brute-nee: 148 spheres).

    python -m csgrenderer_tpu_torch.demos.demo8_night --out night.png
    python -m csgrenderer_tpu_torch.demos.demo8_night --no-nee   (compare the noise)
"""

from __future__ import annotations

import argparse
import sys

from ._common import device_of, how, single_frame, single_frame_argparser


def main(argv=None) -> int:
    ap = single_frame_argparser("demo8_night", width=960, height=540, spp=64, bounces=6)
    ap.add_argument("--nee", default=True, action=argparse.BooleanOptionalAction,
                    help="next-event estimation (--no-nee = plain path tracing)")
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..camera import Camera
    from ..kernels import megakernel
    from ..models import night_scene

    packed = megakernel.pack_scene(night_scene(device=device))
    cam = Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0,
                         aspect_ratio=args.width / args.height, device=device)
    tail = single_frame(args, device, megakernel.KERNEL_SOURCE, lambda: (
        megakernel.render_image_kernel(
            packed, cam, args.width, args.height, spp=args.spp, max_bounces=args.bounces,
            seed=5, sky="black", nee=args.nee)))
    mode = packed.mode + ("-nee" if args.nee else "")
    print(f"[csgr] demo8: {packed.scene.num_spheres} spheres, {args.width}x{args.height} "
          f"spp={args.spp} nee={'on' if args.nee else 'off'} via "
          f"{how(device, f'sphere_megakernel[{mode}]')}: {tail}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
