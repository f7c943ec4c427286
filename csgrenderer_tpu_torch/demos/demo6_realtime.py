"""Demo 6: the reference's headline scenario, live on the GPU.

Twin of ``demos/demo6_realtime.py``. The reference redraws an animated
sphere in a window at interactive rates with a stats line every second
(its app.c:74-214, 1280x720, 60 updates a second, "Test 1"). This demo
runs that scenario through the port's ``App`` loop: the frame sink is a
host ring buffer standing in for the swapchain (plus an optional GIF of
the last frames), with two frames in flight.

``--scene``: "wololo" is the reference's scenario (one sphere, normal
shading); "rtiow" path-traces the RTIOW final scene live (the sphere grid
kernel, fresh noise every frame through advancing sample offsets); "night"
adds next-event estimation on the emissive night scene. ``--denoise``
filters each frame with the a-trous kernel over the AOV G-buffer,
``--target-noise`` adapts the spp per frame (app/adaptive.py) and
``--serve PORT`` streams the run to a browser (app/preview.py; port 0
picks a free one) with orbit controls (app/controls.py).

    python -m csgrenderer_tpu_torch.demos.demo6_realtime --seconds 5
    python -m csgrenderer_tpu_torch.demos.demo6_realtime --scene rtiow --spp 2 --denoise

``--device`` defaults to cuda and exits non-zero without it; ``--device
cpu`` runs the plain versions (a smoke run at a small size).
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import numpy as np
import torch

from ._common import add_device, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--frames-in-flight", type=int, default=2)
    ap.add_argument("--gif", default=None, help="write the last frames as a GIF")
    ap.add_argument("--readback", default="fence", choices=["fence", "full"],
                    help="'fence': keep frames on the device and read one ray count every "
                    "--fence-stride frames (a full frame is a 2.7 MB device-to-host copy at "
                    "1280x720, which the card need not wait for when nothing on the host "
                    "reads the pixels); 'full': copy every frame to the host")
    ap.add_argument("--fence-stride", type=int, default=2)
    ap.add_argument("--min-fps", type=float, default=0.0,
                    help="exit non-zero if the sustained fps falls below this")
    ap.add_argument("--scene", default="wololo", choices=["wololo", "rtiow", "night"],
                    help="wololo: the reference's scenario; rtiow/night: live path tracing "
                    "(fresh noise every frame)")
    ap.add_argument("--spp", type=int, default=2,
                    help="samples per pixel per frame of the path-traced scenes")
    ap.add_argument("--bounces", type=int, default=8)
    ap.add_argument("--denoise", action="store_true",
                    help="a-trous/SVGF denoise each low-spp frame against the deterministic AOV "
                    "G-buffer: the classic realtime path-tracing set-up (2 spp + denoise)")
    ap.add_argument("--denoise-iters", type=int, default=3,
                    help="a-trous passes per frame")
    ap.add_argument("--target-noise", type=float, default=None,
                    help="adapt the spp per frame toward this measured noise (two-stream "
                    "estimate, app/adaptive.py) instead of a fixed --spp")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="live MJPEG preview at http://127.0.0.1:PORT/ (app/preview.py, the "
                    "headless analog of the reference's window; 0 picks a free port)")
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_of(args)

    from ..app import App, PathTraceRenderer, WololoRenderer
    from ..utils.config import RenderConfig

    ring = collections.deque(maxlen=32)  # the "swapchain": the last 32 frames

    preview = None
    if args.serve is not None:
        from ..app.preview import PreviewServer

        preview = PreviewServer(port=args.serve)
        preview.start()
        print(f"[csgr] demo6: live preview at {preview.url}", flush=True)

    def sink(idx, img):
        ring.append((idx, img))
        if preview is not None:
            preview.publish(img)

    rig_pose = None
    if args.scene == "wololo":
        renderer = WololoRenderer(RenderConfig(width=args.width, height=args.height, spp=1,
                                               sky="wololo"), device=device)
    else:
        from ..camera import Camera
        from ..models import night_scene, rtiow_final_scene

        aspect = args.width / args.height
        dn = dict(denoise=args.denoise, denoise_iterations=args.denoise_iters)
        if args.scene == "rtiow":
            scene = rtiow_final_scene(device=device)
            rig_pose = dict(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov_degrees=20.0,
                            aperture=0.1, focus_dist=10.0)
            cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                               max_bounces=args.bounces, seed=6, lens=True, **dn)
        else:  # night: NEE + MIS, live
            scene = night_scene(device=device)
            rig_pose = dict(lookfrom=(6.5, 2.2, 6.5), lookat=(0.0, 0.6, 0.0), vfov_degrees=32.0)
            cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                               max_bounces=args.bounces, seed=6, sky="black", nee=True, **dn)
        cam = Camera.look_at(aspect_ratio=aspect, device=device, **rig_pose)
        if args.target_noise is not None:
            from ..app.adaptive import AdaptiveSppRenderer

            renderer = AdaptiveSppRenderer(scene, cam, cfg, target=args.target_noise,
                                           probe_stride=16, device=device)
        else:
            renderer = PathTraceRenderer(scene, cam, cfg, advance_samples=True, device=device)
    app = App(target_updates_per_sec=60.0, width=args.width, height=args.height,
              caption="Test 1", frame_sink=sink)
    app.swap_scene(renderer)

    # browser-driven camera: drag to orbit, wheel to dolly, Escape to quit
    # (the reference's event poll and window close, app.c:204 and 136)
    if preview is not None and rig_pose is not None:
        from ..app.controls import OrbitController, attach

        rig = OrbitController.from_camera(aspect_ratio=args.width / args.height, **rig_pose)
        attach(app, renderer, preview, rig)
        print("[csgr] demo6: interactive: drag to orbit, wheel to zoom, Esc to quit", flush=True)
    elif preview is not None:
        # wololo's camera is the shader's fixed one; close/Esc still stop it
        def _close_watch(app_, dt):
            for ev in preview.poll_events():
                if ev.get("type") == "close" or (
                        ev.get("type") == "key" and ev.get("code") in ("Escape", "q")):
                    app_.stop()

        app.update_cb = _close_watch

    # build the kernels and warm up before the fps is measured
    renderer.draw_frame(0.0).cpu()

    t0 = time.monotonic()
    ok = app.run(max_seconds=args.seconds, frames_in_flight=args.frames_in_flight,
                 readback=args.readback, fence_stride=args.fence_stride)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    frames = ring[-1][0] + 1 if ring else 0
    fps = frames / wall if wall > 0 else 0.0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[csgr] demo6: {frames} frames in {wall:.2f}s = {fps:.1f} fps sustained at "
          f"{args.width}x{args.height} scene={args.scene} ({args.frames_in_flight} frames in "
          f"flight, {where})", flush=True)

    if preview is not None:
        preview.stop()

    if args.gif and ring:
        from ..io.video import write_gif

        # under fence readback the frames are still on the device: the GIF
        # is the one place that copies them all, at the end
        frames_np = [img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
                     for _, img in list(ring)[-16:]]
        write_gif(args.gif, frames_np, fps=10)
        print(f"[csgr] demo6: wrote {args.gif}", flush=True)

    if not ok:
        return 1
    if args.min_fps and fps < args.min_fps:
        print(f"[csgr] demo6: FAIL sustained {fps:.1f} < {args.min_fps} fps", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
