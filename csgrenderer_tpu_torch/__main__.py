"""CLI: ``python -m csgrenderer_tpu_torch <command> ...``.

Commands:
  render     render a built-in scene to PNG through the app layer's
             renderers: milestone01 (the reference shader's animated
             sphere, WololoRenderer), the sphere scenes rtiow and diffuse,
             the CSG tapes csg (config 3), deepcsg (config 5 at t = 1.0),
             manyobjects and csgnight (black sky, emissive sphere leaves,
             next-event estimation), and the triangle mesh meshnight (black
             sky, emissive quad lamps, next-event estimation), all through
             PathTraceRenderer; ``--target-noise`` renders until the
             measured noise reaches the target instead of one frame
  gif        render an animation to GIF: milestone01, or deepcsg (config 5,
             animated, its tape reclustered every frame)
  info       the device, its power limit, the scenes and the built kernels
  bench      run the benchmark (same as ``python -m csgrenderer_tpu_torch.bench``)

``render`` and ``gif`` run on the GPU (``--device cuda``, the default) and
exit non-zero on a host without CUDA; ``--device cpu`` runs the kernels'
plain torch versions. ``--denoise`` filters the path-traced frame with
the a-trous filter (``--denoise-iters`` passes) over the AOV G-buffer;
milestone01, the reference shader's frame, is never filtered.
"""

from __future__ import annotations

import argparse
import sys

import torch

SCENES = ("milestone01", "diffuse", "csg", "rtiow", "deepcsg", "csgnight", "manyobjects",
          "meshnight")
GIF_SCENES = ("milestone01", "deepcsg")
_NO_CUDA = "no CUDA device: the renderers run the GPU kernels by default; --device cpu runs the plain version"


def _build(scene_name: str, aspect: float, device):
    """(scene or tape, camera, extra render options): the JAX CLI's set-ups."""
    from .camera import Camera
    from .models import (
        animated_csg_scene,
        config3_csg_scene,
        csg_night_scene,
        many_objects_scene,
        mesh_night_scene,
        rtiow_final_scene,
        two_spheres_scene,
    )

    if scene_name == "csg":
        cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=aspect,
                             device=device)
        return config3_csg_scene().compile(device=device), cam, dict()
    if scene_name == "deepcsg":
        graph, animate = animated_csg_scene(8)
        return animate(graph.compile(device=device), 1.0), _deepcsg_camera(aspect, device), dict()
    if scene_name == "manyobjects":
        cam = Camera.look_at((9.0, 7.5, 12.0), (0.0, 0.3, 0.0), vfov_degrees=42.0,
                             aspect_ratio=aspect, device=device)
        return many_objects_scene().compile(device=device), cam, dict()
    if scene_name == "csgnight":
        cam = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0,
                             aspect_ratio=aspect, device=device)
        return csg_night_scene().compile(k=4, device=device), cam, dict(sky="black", nee=True)
    if scene_name == "meshnight":
        cam = Camera.look_at((0, 1.8, 2.4), (0, 0.7, -2.6), vfov_degrees=45.0,
                             aspect_ratio=aspect, device=device)
        return mesh_night_scene(device=device), cam, dict(sky="black", nee=True)
    if scene_name == "diffuse":
        cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                             aspect_ratio=aspect, device=device)
        return two_spheres_scene(device=device), cam, dict()
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=aspect,
                         aperture=0.1, focus_dist=10.0, device=device)
    return rtiow_final_scene(device=device), cam, dict(lens=True)


def _deepcsg_camera(aspect, device):
    from .camera import Camera

    return Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0, aspect_ratio=aspect,
                          device=device)


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(_NO_CUDA)
    return device


def _config(args, **extra):
    from .utils.config import RenderConfig

    return RenderConfig(width=args.width, height=args.height, spp=args.spp,
                        max_bounces=args.bounces, seed=args.seed, denoise=args.denoise,
                        denoise_iterations=args.denoise_iters, **extra)


def _wololo(args, device):
    from .app import WololoRenderer
    from .utils.config import RenderConfig

    return WololoRenderer(RenderConfig(width=args.width, height=args.height, spp=1, sky="wololo"),
                          device=device)


def cmd_render(args) -> None:
    from .app import PathTraceRenderer
    from .io import image

    device = _device(args)
    if args.scene == "milestone01":
        r = _wololo(args, device)
        img, rays = r.draw_frame(args.time), r.last_frame_rays
    else:
        scene, camera, extra = _build(args.scene, args.width / args.height, device)
        r = PathTraceRenderer(scene, camera, _config(args, **extra), device=device)
        if args.target_noise is not None:
            acc, noise, used = r.render_to_noise(target=args.target_noise, max_spp=args.max_spp,
                                                 time_sec=args.time)
            print(f"[csgr] render-to-noise: {used} spp, measured noise {noise:.2e} "
                  f"(target {args.target_noise:.1e})")
            img, rays = r._tonemap(r.denoise_image(acc.image(), args.time)), acc.rays_traced
        else:
            img = r.draw_frame(args.time)
            rays = r.last_frame_rays
    image.write_png(args.out, img.cpu().numpy())
    print(f"[csgr] wrote {args.out} ({args.width}x{args.height}, {int(rays)} rays, {device})")


def cmd_gif(args) -> None:
    from .app import PathTraceRenderer
    from .io import write_gif
    from .models import animated_csg_scene

    device = _device(args)
    if args.scene == "milestone01":
        r = _wololo(args, device)
    else:
        graph, animate = animated_csg_scene(8)
        r = PathTraceRenderer(graph.compile(device=device),
                              _deepcsg_camera(args.width / args.height, device), _config(args),
                              animate=animate, device=device)
    frames = [r.draw_frame(i / args.fps).cpu().numpy() for i in range(args.frames)]
    write_gif(args.out, frames, fps=args.fps)
    print(f"[csgr] wrote {args.out} ({len(frames)} frames, {device})")


def cmd_info(args) -> None:
    import csgrenderer_tpu_torch

    from .bench import card_info
    from .kernels import build

    print(f"csgrenderer-tpu-torch {csgrenderer_tpu_torch.__version__} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
              f"nvidia-smi: {card_info() or 'not available'}")
    else:
        print("device: no CUDA device (--device cpu runs the plain versions)")
    print(f"scenes: {', '.join(SCENES)}; gif: {', '.join(GIF_SCENES)}")
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    built = sorted(p.name for p in build.BUILD_DIR.glob("*.so")) if build.BUILD_DIR.is_dir() else []
    print(f"kernels: {', '.join(sources)} (csrc); built: {', '.join(built) or 'none yet'}")
    try:
        from .scene.native import ensure_built

        print(f"native scene core: {ensure_built()}")
    except (OSError, RuntimeError) as e:  # no compiler, or the build failed
        print(f"native scene core: unavailable ({e})")


def _add_common(ap) -> None:
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (the plain torch version)")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--denoise", action="store_true",
                    help="a-trous/SVGF denoise over the AOV G-buffer (render/denoise.py): "
                         "low-spp renders converge visually at a fraction of the sample cost")
    ap.add_argument("--denoise-iters", type=int, default=4,
                    help="a-trous passes (filter radius 2^iters pixels)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="csgrenderer_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="rtiow", choices=SCENES)
    r.add_argument("--time", type=float, default=0.0)
    r.add_argument("--target-noise", type=float, default=None,
                   help="render to measured noise instead of one --spp frame: accumulate spp "
                        "chunks until the two-stream estimate reaches this (e.g. 1e-3)")
    r.add_argument("--max-spp", type=int, default=1 << 14)
    _add_common(r)
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("gif", help="render an animation to GIF")
    g.add_argument("--scene", default="deepcsg", choices=GIF_SCENES)
    g.add_argument("--frames", type=int, default=12)
    g.add_argument("--fps", type=float, default=8.0)
    _add_common(g)
    g.set_defaults(fn=cmd_gif)

    i = sub.add_parser("info", help="device, scenes and kernels")
    i.set_defaults(fn=cmd_info)

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
