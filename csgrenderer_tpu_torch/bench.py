"""Benchmark: Mrays/s of traced segments, per scene.

The port's counterpart of the repository's ``bench.py`` (which measures
the JAX package) and ``tools/bench_tape.py``. ``--scene`` picks the frame:

- ``rtiow`` (the default): the RTIOW final scene (487 spheres, grid mode)
  through the thin-lens camera at 1920x1080, 64 spp, 8 bounces, rendered
  by the CUDA sphere kernel;
- ``deepcsg``: BASELINE config 5 as ``tools/bench_tape.py`` builds it, the
  depth-8 animated CSG chain at t = 1.0 (``compile(k=4)``), camera
  (0, 2, 7) -> (0.5, 0, 0), vfov 40, clustered (``partition="auto"``), at
  1920x1080, 64 spp, 5 bounces, rendered by the CUDA tape kernel;
- ``manyobjects``: ``many_objects_scene(99).compile(k=4)`` (199 leaves,
  100 clusters), camera (0, 7, 9) -> (0, 0.4, 0), vfov 45, at 1280x720,
  16 spp, 8 bounces, through the tape kernel;
- the night scenes, black sky and next-event estimation (MIS) toward
  their emissive sphere lamps, at the NEE frame of doc/PERF_NOTES.md
  (960x540, 64 spp, 6 bounces): ``night`` (``night_scene()``, 148
  spheres, the sphere kernel's brute mode) and ``night488``
  (``night_scene(grid=11)``, 488 spheres, grid mode), both through demo
  8's camera (6.5, 2.2, 6.5) -> (0, 0.6, 0), vfov 32; ``csgnight``
  (``csg_night_scene().compile(k=4)``, clustered) through demo 9's
  camera (4.5, 2.6, 4.8) -> (0, 0.8, 0.3), vfov 38, on the tape kernel.
  Shadow rays are not counted as segments;
- the triangle-mesh scenes, through the CUDA mesh kernel: ``mesh``
  (``mesh_demo_scene(4, 3)``, 15,362 faces, grid mode, the scene and
  camera (0, 1.6, 2.2) -> (0, 0.7, -2.6), vfov 45, of
  ``tools/bench_mesh.py``) at 1280x720, 16 spp, 6 bounces, rtiow sky;
  ``meshnight`` (``mesh_night_scene()``, 966 faces, four of them lamps,
  grid-nee) through the render CLI's camera (0, 1.8, 2.4) ->
  (0, 0.7, -2.6), vfov 45, at the NEE frame 960x540, 64 spp, 6 bounces.

Prints ONE JSON line:

  {"metric": "Mrays/sec/chip", "value": N, "p50_frame_ms_16spp": N, ...}

(every scene but rtiow adds ``"scene"``).

``value`` is the median-frame throughput over ``--frames`` identical
frames (fresh sample offsets each), ``value_mean`` the mean; rays are
traced path segments, summed in int64. Each frame is fenced: the ray
count is read back to the host, after ``torch.cuda.synchronize()``,
inside the timed window. The p50 frame time is measured at 16 spp.

Usage:
  python -m csgrenderer_tpu_torch.bench                   # full frame, on the GPU
  python -m csgrenderer_tpu_torch.bench --quick           # 320x180, 4 spp
  python -m csgrenderer_tpu_torch.bench --scene deepcsg   # config 5, 1080p/64 spp
  python -m csgrenderer_tpu_torch.bench --scene night     # NEE, 960x540/64 spp
  python -m csgrenderer_tpu_torch.bench --scene mesh      # 15,362 faces, 1280x720/16 spp

The benchmark runs on the GPU (``--device cuda``, the default) and exits
non-zero on a host without CUDA. ``--device cpu`` runs the plain torch
version on the CPU instead, and the line says ``"platform": "cpu"``,
``"backend": "torch-plain"``: a smoke run, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from .camera import Camera
from .kernels import megakernel, tape_kernel, trimesh_kernel
from .models import (
    animated_csg_scene,
    csg_night_scene,
    many_objects_scene,
    mesh_demo_scene,
    mesh_night_scene,
    night_scene,
    rtiow_final_scene,
)

# scene -> (full, quick) frames as (width, height, spp, bounces)
FRAMES = {
    "rtiow": ((1920, 1080, 64, 8), (320, 180, 4, 8)),
    "deepcsg": ((1920, 1080, 64, 5), (320, 180, 4, 5)),
    "manyobjects": ((1280, 720, 16, 8), (320, 180, 4, 8)),
    "night": ((960, 540, 64, 6), (320, 180, 4, 6)),
    "night488": ((960, 540, 64, 6), (320, 180, 4, 6)),
    "csgnight": ((960, 540, 64, 6), (320, 180, 4, 6)),
    "mesh": ((1280, 720, 16, 6), (320, 180, 4, 6)),
    "meshnight": ((960, 540, 64, 6), (320, 180, 4, 6)),
}
FULL, QUICK = FRAMES["rtiow"]
KERNEL_NAME = {"rtiow": "sphere_megakernel", "deepcsg": "tape_kernel", "manyobjects": "tape_kernel",
               "night": "sphere_megakernel", "night488": "sphere_megakernel",
               "csgnight": "tape_kernel", "mesh": "trimesh_kernel", "meshnight": "trimesh_kernel"}
LABEL = {"rtiow": "RTIOW-final", "deepcsg": "config5-deepcsg-t1", "manyobjects": "many-objects-99",
         "night": "night-148-nee", "night488": "night-488-nee", "csgnight": "csg-night-nee",
         "mesh": "mesh-demo-15362", "meshnight": "mesh-night-966-nee"}
NO_CUDA = "no CUDA device: the benchmark measures the GPU kernel (--device cpu runs the plain version)"


def card_info() -> str | None:
    """GPU 0's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def build_renderer(width: int, height: int, spp: int, bounces: int, device, scene: str = "rtiow"):
    """run(sample_offset) -> (image, rays) for the benchmark frame; the scene
    is packed once (for a tape: clustered on the host), outside any timed
    window."""
    aspect = width / height
    if scene == "rtiow":
        packed = megakernel.pack_scene(rtiow_final_scene(device=device))
        camera = Camera.look_at(
            (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov_degrees=20.0,
            aspect_ratio=aspect, aperture=0.1, focus_dist=10.0, device=device,
        )
        render, extra = megakernel.render_image_kernel, dict(lens=True)
    elif scene == "deepcsg":
        graph, animate = animated_csg_scene(n_levels=8)
        packed = tape_kernel.pack_program(animate(graph.compile(k=4, device=device), 1.0))
        camera = Camera.look_at((0.0, 2.0, 7.0), (0.5, 0.0, 0.0), vfov_degrees=40.0,
                                aspect_ratio=aspect, device=device)
        render, extra = tape_kernel.render_image_tape_kernel, dict()
    elif scene == "manyobjects":
        packed = tape_kernel.pack_program(many_objects_scene(99).compile(k=4, device=device))
        camera = Camera.look_at((0.0, 7.0, 9.0), (0.0, 0.4, 0.0), vfov_degrees=45.0,
                                aspect_ratio=aspect, device=device)
        render, extra = tape_kernel.render_image_tape_kernel, dict()
    elif scene in ("night", "night488"):
        packed = megakernel.pack_scene(night_scene(grid=6 if scene == "night" else 11,
                                                   device=device))
        camera = Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0,
                                aspect_ratio=aspect, device=device)
        render, extra = megakernel.render_image_kernel, dict(sky="black", nee=True)
    elif scene == "csgnight":
        packed = tape_kernel.pack_program(csg_night_scene().compile(k=4, device=device))
        camera = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0,
                                aspect_ratio=aspect, device=device)
        render, extra = tape_kernel.render_image_tape_kernel, dict(sky="black", nee=True)
    elif scene == "mesh":
        packed = trimesh_kernel.pack_mesh(mesh_demo_scene(4, 3, device=device))
        camera = Camera.look_at((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), vfov_degrees=45.0,
                                aspect_ratio=aspect, device=device)
        render, extra = trimesh_kernel.render_image_mesh_kernel, dict()
    elif scene == "meshnight":
        packed = trimesh_kernel.pack_mesh(mesh_night_scene(device=device))
        camera = Camera.look_at((0.0, 1.8, 2.4), (0.0, 0.7, -2.6), vfov_degrees=45.0,
                                aspect_ratio=aspect, device=device)
        render, extra = trimesh_kernel.render_image_mesh_kernel, dict(sky="black", nee=True)
    else:
        raise ValueError(f"unknown scene {scene!r}; choose from {sorted(FRAMES)}")

    def run(sample_offset: int):
        return render(
            packed, camera, width, height, spp=spp, max_bounces=bounces,
            seed=0, sample_offset=sample_offset, **extra,
        )

    return run, packed.mode + ("-nee" if extra.get("nee") else "")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_frames(fn, n_frames: int, device):
    """(frame seconds, total rays, last image) over n_frames fenced frames."""
    times, total_rays, img = [], 0, None
    for i in range(n_frames):
        _sync(device)
        t0 = time.perf_counter()
        img, rays = fn(i + 1)
        r = int(rays)  # host readback of the count is part of the frame
        _sync(device)
        times.append(time.perf_counter() - t0)
        total_rays += r
    return times, total_rays, img


def trace_frame(fn, device, kernel_name: str = "sphere_megakernel") -> dict:
    """One more frame under torch.profiler (after the timed frames, so the
    tracing cost stays out of them): the kernel's device time, all device
    time, the frame's host time and the device's idle share of it."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        int(fn(0)[1])
        _sync(device)
        frame_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    kernel_us = sum(e.self_device_time_total for e in events if kernel_name in e.key)
    return {
        "frame_ms": frame_s * 1e3,
        "device_ops": sum(e.count for e in events),  # kernels and copies on the device
        "device_busy_ms": device_us / 1e3 if device_us else None,  # None: not measured
        "kernel_ms": kernel_us / 1e3 if kernel_us else None,
        "device_idle_share": 1.0 - device_us / 1e6 / frame_s if device_us else None,
    }


def run_bench(quick: bool = False, frames: int = 5, device="cuda", trace: bool = False,
              scene: str = "rtiow"):
    """Measure; returns (the JSON-able result, the last full-config image)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    if scene not in FRAMES:
        raise ValueError(f"unknown scene {scene!r}; choose from {sorted(FRAMES)}")
    width, height, spp, bounces = FRAMES[scene][1 if quick else 0]

    fn, mode = build_renderer(width, height, spp, bounces, device, scene)
    int(fn(0)[1])  # warm-up: builds the kernel on first use
    times, rays, img = time_frames(fn, frames, device)
    mrays = rays / len(times) / statistics.median(times) / 1e6
    mrays_mean = rays / sum(times) / 1e6
    traced = trace_frame(fn, device, KERNEL_NAME[scene]) if trace and device.type == "cuda" else None

    fn16, _ = build_renderer(width, height, 2 if quick else 16, bounces, device, scene)
    int(fn16(0)[1])
    t16, _, _ = time_frames(fn16, max(frames, 3), device)
    p50_ms = statistics.median(t16) * 1e3

    if device.type == "cuda":
        card = card_info()
        power = card.rpartition(",")[2].strip() if card else None
        device_name = torch.cuda.get_device_name(device)
    else:
        card, power, device_name = None, None, "cpu"
    result = {
        "metric": "Mrays/sec/chip",
        "value": mrays,
        "unit": "Mrays/s",
        "config": f"{LABEL[scene]} {width}x{height} spp={spp} bounces={bounces} mode={mode}",
        "p50_frame_ms_16spp": p50_ms,
        "backend": "cuda-kernel" if device.type == "cuda" else "torch-plain",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_name": device_name,
        "nvidia_smi": card,
        "power_limit": power,
        "frames": frames,
        "rays": rays,
        "value_mean": mrays_mean,
        "frame_times_s": times,
    }
    if trace:
        result["trace"] = traced
    if scene != "rtiow":
        result["scene"] = scene
    return result, img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m csgrenderer_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="rtiow", choices=sorted(FRAMES),
                    help="rtiow (spheres, the default), deepcsg (config 5), manyobjects, "
                         "the NEE night scenes night, night488 and csgnight, or the "
                         "triangle meshes mesh and meshnight")
    ap.add_argument("--quick", action="store_true", help="320x180, 4 spp")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, the default) or cpu (the plain torch version)")
    ap.add_argument("--trace", action="store_true",
                    help="add one profiled frame: kernel and device busy time, idle share")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: {NO_CUDA}", file=sys.stderr)
        return 2
    result, _ = run_bench(args.quick, args.frames, args.device, args.trace, args.scene)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
