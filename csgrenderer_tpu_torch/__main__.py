"""CLI: ``python -m csgrenderer_tpu_torch <command> ...``.

Commands:
  render     render a built-in scene to PNG: the sphere scenes rtiow and
             diffuse, the CSG tapes csg (config 3), deepcsg (config 5 at
             t = 1.0), manyobjects and csgnight (black sky, emissive sphere
             leaves, next-event estimation)
  bench      run the benchmark (same as ``python -m csgrenderer_tpu_torch.bench``)

``render`` runs on the GPU (``--device cuda``, the default) and exits
non-zero on a host without CUDA; ``--device cpu`` runs the plain torch
version. The other scenes of the JAX package's CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import torch

PORTED = ("rtiow", "diffuse", "csg", "deepcsg", "manyobjects", "csgnight")
NOT_PORTED = ("milestone01", "meshnight")
TAPE_SCENES = ("csg", "deepcsg", "manyobjects", "csgnight")


def _build(scene_name: str, aspect: float, device):
    """(scene or tape, camera, extra render options): the JAX CLI's set-ups."""
    from .camera import Camera
    from .models import (
        animated_csg_scene,
        config3_csg_scene,
        csg_night_scene,
        many_objects_scene,
        rtiow_final_scene,
        two_spheres_scene,
    )

    if scene_name == "csg":
        cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=aspect,
                             device=device)
        return config3_csg_scene().compile(device=device), cam, dict()
    if scene_name == "deepcsg":
        graph, animate = animated_csg_scene(8)
        cam = Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0, aspect_ratio=aspect,
                             device=device)
        return animate(graph.compile(device=device), 1.0), cam, dict()
    if scene_name == "manyobjects":
        cam = Camera.look_at((9.0, 7.5, 12.0), (0.0, 0.3, 0.0), vfov_degrees=42.0,
                             aspect_ratio=aspect, device=device)
        return many_objects_scene().compile(device=device), cam, dict()
    if scene_name == "csgnight":
        cam = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0,
                             aspect_ratio=aspect, device=device)
        return csg_night_scene().compile(k=4, device=device), cam, dict(sky="black", nee=True)
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
    from .kernels.tape_kernel import render_image_tape_kernel
    from .render.tonemap import tonemap, to_uint8

    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: render runs the GPU kernels by default; "
                         "--device cpu runs the plain version")
    scene, camera, extra = _build(args.scene, args.width / args.height, device)
    render = render_image_tape_kernel if args.scene in TAPE_SCENES else render_image_kernel
    img, rays = render(
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
    r.add_argument("--device", default="cuda",
                   help="cuda (the kernels, the default) or cpu (the plain torch version)")
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
