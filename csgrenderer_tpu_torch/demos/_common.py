"""Shared demo plumbing: argument parsing, the device, kernel builds,
frame sinks and the run loop.

Twin of ``demos/_common.py``. ``--device`` takes the place of the JAX
demos' ``--cpu``: cuda (the default) runs the port's kernels and exits
non-zero on a host without CUDA; cpu runs their plain versions. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from ..app import App, StatsClock
from ..io import image
from ..kernels import build

NO_CUDA = "--device cuda but CUDA is not available (--device cpu runs the plain versions)"


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the kernels, the default) or cpu (their plain versions)")


def demo_argparser(description: str, **defaults) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--width", type=int, default=defaults.get("width", 1280))
    ap.add_argument("--height", type=int, default=defaults.get("height", 720))
    ap.add_argument("--spp", type=int, default=defaults.get("spp", 16))
    ap.add_argument("--bounces", type=int, default=defaults.get("bounces", 8))
    ap.add_argument("--frames", type=int, default=defaults.get("frames", 1))
    ap.add_argument("--seed", type=int, default=defaults.get("seed", 0))
    ap.add_argument("--out", type=str, default=defaults.get("out", "out"))
    add_device(ap)
    return ap


def device_of(args) -> torch.device:
    """The demo's device; exits non-zero where cuda is asked for and absent."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(NO_CUDA)
    return torch.device(args.device)


def prebuild(device: torch.device, *sources: str) -> float:
    """Build (or load) the kernels of ``sources`` before anything is timed,
    so no printed time includes nvcc; returns the seconds that took (0 on
    the CPU, which runs the plain versions)."""
    if device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    for source in sources:
        build.load(source)
    return time.perf_counter() - t0


def how(device: torch.device, kernel: str) -> str:
    """What ran, for the printed lines: the kernel mode on the card, else
    the plain version."""
    if device.type == "cuda":
        return f"{kernel} on {torch.cuda.get_device_name(device)}"
    return f"the plain version of {kernel} on the cpu"


def host(img) -> np.ndarray:
    return img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def png_sink(out_dir: str, prefix: str):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def sink(frame_idx: int, img) -> None:
        path = out / f"{prefix}_{frame_idx:04d}.png"
        image.write_png(path, host(img))
        print(f"[csgr] wrote {path}", flush=True)

    return sink


def single_frame(args, device: torch.device, source: str, render) -> str:
    """Demos 7-9: build kernel ``source``, time ``render() -> (radiance,
    rays)`` to its end, write the frame (gamma 2) to ``--out``; returns the
    printed line's tail: the rate, what the time covers and the file."""
    from ..render import tonemap

    build_s = prebuild(device, source)
    t0 = time.perf_counter()
    radiance, rays = render()
    n_rays = int(rays)  # waits for the frame
    dt = time.perf_counter() - t0
    image.write_png(args.out, host(tonemap.to_uint8(tonemap.tonemap(radiance, gamma=2.0))))
    return f"{n_rays / dt / 1e6:.1f} Mrays/s ({render_only(device, build_s)}) -> {args.out}"


def render_only(device: torch.device, build_s: float) -> str:
    """What a printed time covers: the render, without the kernel build."""
    return f"render only, nvcc build {build_s:.1f} s excluded" if device.type == "cuda" else \
        "render only"


def single_frame_argparser(name: str, **defaults) -> argparse.ArgumentParser:
    """Demos 7-9's options: the frame, ``--out`` (one PNG, by default
    ``csgr_<name>.png`` in the temporary directory) and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=defaults["width"])
    ap.add_argument("--height", type=int, default=defaults["height"])
    ap.add_argument("--spp", type=int, default=defaults["spp"])
    ap.add_argument("--bounces", type=int, default=defaults["bounces"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), f"csgr_{name}.png"))
    add_device(ap)
    return ap


def run_demo(renderer, args, prefix: str, ups: float = 60.0) -> None:
    """Drive a renderer through the App loop for --frames frames."""
    app = App(
        target_updates_per_sec=ups,
        width=args.width,
        height=args.height,
        caption=prefix,
        init_cb=lambda app, w, h, cap, dt: (app.swap_scene(renderer), True)[1],
        frame_sink=png_sink(args.out, prefix),
        stats=StatsClock(),
    )
    if not app.run(max_frames=args.frames):
        raise SystemExit(1)
