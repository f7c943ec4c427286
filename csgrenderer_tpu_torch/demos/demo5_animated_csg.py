"""Config 5: the animated depth-8 CSG chain, progressive 4K, an orbiting camera.

Twin of ``demos/demo5_animated_csg.py``. On the card each frame is one
launch of the tape kernel: the edge transforms are animated and rebaked
on the device, and the tape's clusters are recomputed on a CPU copy each
frame (``app/renderers.py``). Progressive accumulation state is saved
with ``--checkpoint`` and resumed with ``--resume`` (the npz layout of
``io/checkpoint.py``, shared with the JAX package, so either package's
file resumes in the other); under the counter-based RNG a resumed run
composes exactly with the run that wrote the checkpoint.

    python -m csgrenderer_tpu_torch.demos.demo5_animated_csg --width 3840 --height 2160 --frames 8
    python -m csgrenderer_tpu_torch.demos.demo5_animated_csg --width 512 --height 512 --frames 4 --device cpu
"""

from __future__ import annotations

import math

from ._common import demo_argparser, device_of, png_sink, prebuild


def main(argv=None) -> None:
    ap = demo_argparser("animated deep CSG, progressive", width=3840, height=2160, spp=2,
                        bounces=5, frames=4)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera per frame (disables accumulation)")
    ap.add_argument("--target-noise", type=float, default=None,
                    help="render to measured noise instead of --frames: accumulate spp chunks "
                    "until the two-stream estimate reaches this (e.g. 1e-3, the fidelity budget)")
    ap.add_argument("--max-spp", type=int, default=1 << 14,
                    help="noise-targeted rendering stops here regardless")
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..app import PathTraceRenderer
    from ..camera import Camera
    from ..io import checkpoint
    from ..kernels import tape_kernel
    from ..models import animated_csg_scene
    from ..utils.config import RenderConfig

    graph, animate = animated_csg_scene(n_levels=8)
    tape = graph.compile(device=device)

    def camera_at(angle: float) -> Camera:
        r = 7.0
        return Camera.look_at((r * math.sin(angle), 2.0, r * math.cos(angle)), (0.5, 0, 0),
                              vfov_degrees=40.0, aspect_ratio=args.width / args.height,
                              device=device)

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.bounces, seed=args.seed)
    prebuild(device, tape_kernel.KERNEL_SOURCE)
    sink = png_sink(args.out, "deepcsg")

    if args.orbit:  # a new camera each frame: one renderer per frame, nothing accumulated
        for i in range(args.frames):
            renderer = PathTraceRenderer(tape, camera_at(0.15 * i), cfg, animate=animate,
                                         device=device)
            sink(i, renderer.draw_frame(i / 24.0))
        return

    renderer = PathTraceRenderer(tape, camera_at(0.6), cfg, animate=animate, progressive=True,
                                 device=device)
    if args.resume:
        renderer.accumulator, _ = checkpoint.load(args.resume, device=device)
        renderer._sample_offset = int(renderer.accumulator.sample_count)
        print(f"[csgr] resumed at {int(renderer.accumulator.sample_count)} spp", flush=True)

    t_frozen = 1.0  # progressive accumulation needs a frozen scene time
    if args.target_noise is not None:
        acc, noise, used = renderer.render_to_noise(target=args.target_noise,
                                                    max_spp=args.max_spp, time_sec=t_frozen)
        print(f"[csgr] render-to-noise: {used} spp, measured noise {noise:.2e} "
              f"(target {args.target_noise:.1e})", flush=True)
        sink(0, renderer._tonemap(acc.image()))
    else:
        for i in range(args.frames):
            sink(i, renderer.draw_frame(t_frozen))
    print(f"[csgr] accumulated {int(renderer.accumulator.sample_count)} spp, "
          f"{int(renderer.accumulator.rays_traced)} rays", flush=True)
    if args.checkpoint:
        checkpoint.save(args.checkpoint, renderer.accumulator)
        print(f"[csgr] checkpoint -> {args.checkpoint}", flush=True)


if __name__ == "__main__":
    main()
