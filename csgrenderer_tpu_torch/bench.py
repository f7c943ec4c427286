"""Benchmark: Mrays/s of traced segments on the RTIOW final scene.

The port's counterpart of the repository's ``bench.py`` (which measures
the JAX package). One frame is the RTIOW final scene (487 spheres, grid
mode) through the thin-lens camera at 1920x1080, 64 spp, 8 bounces,
rendered by the CUDA sphere kernel. Prints ONE JSON line:

  {"metric": "Mrays/sec/chip", "value": N, "p50_frame_ms_16spp": N, ...}

``value`` is the median-frame throughput over ``--frames`` identical
frames (fresh sample offsets each), ``value_mean`` the mean; rays are
traced path segments, summed in int64. Each frame is fenced: the ray
count is read back to the host, after ``torch.cuda.synchronize()``,
inside the timed window. The p50 frame time is measured at 16 spp.

Usage:
  python -m csgrenderer_tpu_torch.bench            # full frame, on the GPU
  python -m csgrenderer_tpu_torch.bench --quick    # 320x180, 4 spp

Without a CUDA device (or with ``--device cpu``) the plain torch version
runs on the CPU and the line says ``"platform": "cpu"``, ``"backend":
"torch-plain"``: a smoke run, not a measurement. ``--device cuda`` on a
host without CUDA fails.
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
from .kernels.megakernel import pack_scene, render_image_kernel
from .models import rtiow_final_scene

FULL = (1920, 1080, 64, 8)
QUICK = (320, 180, 4, 8)


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


def build_renderer(width: int, height: int, spp: int, bounces: int, device):
    """run(sample_offset) -> (image, rays) for the benchmark frame; the scene
    is packed once, outside any timed window."""
    packed = pack_scene(rtiow_final_scene(device=device))
    camera = Camera.look_at(
        (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov_degrees=20.0,
        aspect_ratio=width / height, aperture=0.1, focus_dist=10.0, device=device,
    )

    def run(sample_offset: int):
        return render_image_kernel(
            packed, camera, width, height, spp=spp, max_bounces=bounces,
            seed=0, lens=True, sample_offset=sample_offset,
        )

    return run, packed.mode


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


def trace_frame(fn, device) -> dict:
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
    kernel_us = sum(e.self_device_time_total for e in events if "sphere_megakernel" in e.key)
    return {
        "frame_ms": frame_s * 1e3,
        "device_busy_ms": device_us / 1e3 if device_us else None,  # None: not measured
        "kernel_ms": kernel_us / 1e3 if kernel_us else None,
        "device_idle_share": 1.0 - device_us / 1e6 / frame_s if device_us else None,
    }


def run_bench(quick: bool = False, frames: int = 5, device="cuda", trace: bool = False):
    """Measure; returns (the JSON-able result, the last full-config image)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the GPU kernel")
    width, height, spp, bounces = QUICK if quick else FULL

    fn, mode = build_renderer(width, height, spp, bounces, device)
    int(fn(0)[1])  # warm-up: builds the kernel on first use
    times, rays, img = time_frames(fn, frames, device)
    mrays = rays / len(times) / statistics.median(times) / 1e6
    mrays_mean = rays / sum(times) / 1e6
    traced = trace_frame(fn, device) if trace and device.type == "cuda" else None

    fn16, _ = build_renderer(width, height, 2 if quick else 16, bounces, device)
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
        "config": f"RTIOW-final {width}x{height} spp={spp} bounces={bounces} mode={mode}",
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
    return result, img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m csgrenderer_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="320x180, 4 spp")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the kernel) or cpu (the plain torch version); "
                         "default: cuda if present")
    ap.add_argument("--trace", action="store_true",
                    help="add one profiled frame: kernel and device busy time, idle share")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    result, _ = run_bench(args.quick, args.frames, device, args.trace)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
