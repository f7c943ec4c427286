"""Config 1: milestone-01, the animated normal-shaded sphere on a sky gradient.

Twin of ``demos/demo1_sphere_normals.py``: the reference demo
(``src/wololo_demo/main.c`` + ``ubershader1.frag``) with the same
scene-graph build and the same hard-coded shader scene, rendered headless
to PNGs through ``WololoRenderer`` (torch ops on the chosen device).

    python -m csgrenderer_tpu_torch.demos.demo1_sphere_normals --frames 3 --width 640 --height 480
"""

from __future__ import annotations

from ._common import demo_argparser, device_of, run_demo


def main(argv=None) -> None:
    args = demo_argparser(
        "milestone-01 sphere normals", width=640, height=480, spp=1, frames=1
    ).parse_args(argv)
    device = device_of(args)

    from ..app import WololoRenderer
    from ..models import milestone01_scene_graph
    from ..utils.config import RenderConfig

    # the scene-graph side of the reference demo (main.c:40-50): build the
    # union and print the root flags the demo prints
    graph = milestone01_scene_graph()
    print("Sphere1 is root: %d\nSphere2 is root: %d\nBlob is root: %d"
          % (graph.is_root(0), graph.is_root(1), graph.is_root(2)), flush=True)

    renderer = WololoRenderer(
        RenderConfig(width=args.width, height=args.height, spp=1, sky="wololo"), device=device)
    run_demo(renderer, args, "milestone01")


if __name__ == "__main__":
    main()
