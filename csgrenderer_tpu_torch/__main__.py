"""CLI: ``python -m csgrenderer_tpu_torch <command> ...``.

Commands:
  render     render a built-in sphere scene to PNG (rtiow, diffuse)
  bench      run the benchmark (same as ``python -m csgrenderer_tpu_torch.bench``)

The other scenes of the JAX package's CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

PORTED = ("rtiow", "diffuse")
NOT_PORTED = ("milestone01", "csg", "deepcsg", "csgnight", "manyobjects", "meshnight")


def _build(scene_name: str, aspect: float, device):
    from .camera import Camera
    from .models import rtiow_final_scene, two_spheres_scene

    if scene_name == "diffuse":
        cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                             aspect_ratio=aspect, device=device)
        return two_spheres_scene(device=device), cam, dict()
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=aspect,
                         aperture=0.1, focus_dist=10.0, device=device)
    return rtiow_final_scene(device=device), cam, dict(lens=True)


def cmd_render(args) -> None:
    if args.scene not in PORTED:
        raise SystemExit(f"scene {args.scene!r} is not yet ported (ROADMAP A4-A7); "
                         f"ported: {', '.join(PORTED)}")
    from .io import image
    from .kernels.megakernel import render_image_kernel
    from .render.tonemap import tonemap, to_uint8

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    scene, camera, extra = _build(args.scene, args.width / args.height, device)
    img, rays = render_image_kernel(
        scene, camera, args.width, args.height, spp=args.spp,
        max_bounces=args.bounces, seed=args.seed, **extra,
    )
    image.write_png(args.out, to_uint8(tonemap(img)).cpu().numpy())
    print(f"[csgr] wrote {args.out} ({args.width}x{args.height}, {int(rays)} rays, {device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="csgrenderer_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="rtiow", choices=PORTED + NOT_PORTED)
    r.add_argument("--width", type=int, default=640)
    r.add_argument("--height", type=int, default=360)
    r.add_argument("--spp", type=int, default=8)
    r.add_argument("--bounces", type=int, default=8)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default=None, help="cuda or cpu (default: cuda if present)")
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    sub.add_parser("bench", help="run the benchmark (its options follow)", add_help=False)

    args, rest = ap.parse_known_args(argv)
    if args.cmd == "bench":
        from . import bench

        raise SystemExit(bench.main(rest))
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
