"""Demo 9: next-event estimation on a night scene built from CSG solids.

Twin of ``demos/demo9_csg_night.py``. Demo 8 lights a sphere soup; this
one lights booleans: a bitten sphere (sphere ∖ box), a glass lens
(sphere ∩ sphere) and a metal ring (cylinder ∖ cylinder) under two
emissive sphere leaves of the compiled tape. On the card the frame is one
launch of the tape kernel, whose shadow rays reuse its event-flip
evaluation; without NEE the black-sky scene is a noise field at 64 spp.

    python -m csgrenderer_tpu_torch.demos.demo9_csg_night --out csg_night.png
    python -m csgrenderer_tpu_torch.demos.demo9_csg_night --no-nee   (compare the noise)
"""

from __future__ import annotations

import argparse
import sys

from ._common import device_of, how, single_frame, single_frame_argparser


def main(argv=None) -> int:
    ap = single_frame_argparser("demo9_csg_night", width=960, height=540, spp=64, bounces=6)
    ap.add_argument("--nee", default=True, action=argparse.BooleanOptionalAction,
                    help="next-event estimation (--no-nee = plain path tracing)")
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..camera import Camera
    from ..kernels import tape_kernel
    from ..models import csg_night_scene

    packed = tape_kernel.pack_program(csg_night_scene().compile(k=4, device=device))
    cam = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0,
                         aspect_ratio=args.width / args.height, device=device)
    tail = single_frame(args, device, tape_kernel.KERNEL_SOURCE, lambda: (
        tape_kernel.render_image_tape_kernel(
            packed, cam, args.width, args.height, spp=args.spp, max_bounces=args.bounces,
            seed=9, sky="black", nee=args.nee)))
    mode = packed.mode + ("-nee" if args.nee else "")
    print(f"[csgr] demo9: {packed.tape.n_leaves}-leaf CSG tape, {args.width}x{args.height} "
          f"spp={args.spp} nee={'on' if args.nee else 'off'} via "
          f"{how(device, f'tape_kernel[{mode}]')}: {tail}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
