"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a non-zero exit):

1. Environment: torch/CUDA/nvcc versions, the card and its power limit;
   build the CUDA sphere kernel from csgrenderer_tpu_torch/kernels/csrc.
2. Kernel against its plain torch version on the card, in brute mode
   (two spheres; the small RTIOW scene) and grid mode (the RTIOW final
   scene at 320x180, 4 spp, 8 bounces), and grid mode against forced brute
   mode; then each mode at the frame the main path gives it (1920x1080:
   grid on the RTIOW final scene, brute on the two-sphere scene), whose
   errors and times the kernel line reports. Bounds
   (tests/test_kernels.py::compare): RMSE <= 2e-2, at most 1% of pixels
   off by more than 0.05 in any channel, rays within max(2e-3 * ref, 8).
3. The main path: the benchmark (python -m csgrenderer_tpu_torch.bench) at
   1920x1080, 64 spp, 8 bounces plus the 16-spp p50, and the render CLI on
   the two-sphere scene (brute mode) at 1920x1080, 16 spp. Each kernel
   mode must have launched in this phase.

The last line of output is the device JSON; the line before it lists the
kernels with their launch counts, errors and times. There is no CPU
fallback: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
SOURCE = "csgrenderer_tpu_torch/kernels/csrc/sphere_megakernel.cu"
REPLACES = "csgrenderer_tpu/kernels/megakernel.py:775"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def compare(name, ref, ref_rays, img, rays):
    """compare() bounds of tests/test_kernels.py; returns (rmse, bad, max_abs)."""
    import torch

    if not bool(torch.isfinite(img).all()):
        fail(f"{name}: non-finite pixels")
    diff = (ref - img).abs()
    rmse = float(torch.sqrt(torch.mean((ref - img) ** 2)))
    bad = float((diff.amax(dim=-1) > 0.05).float().mean())
    max_abs = float(diff.max())
    ok_rays = abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)
    print(f"[chip_smoke] {name}: rmse {rmse:.3e} divergent {bad:.4%} max_abs {max_abs:.3e} "
          f"rays {int(rays)} vs {int(ref_rays)}", flush=True)
    if rmse > 2e-2 or bad > 0.01 or not ok_rays:
        fail(f"{name}: outside the compare bounds")
    return rmse, bad, max_abs


def timed(fn, reps):
    """(result of the last call, mean ms per call) with CUDA events."""
    import torch

    out = fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.__main__ import main as cli_main
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene

    dev = torch.device("cuda")

    # --- phase 1: environment and build
    print(f"[chip_smoke] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    print(f"[chip_smoke] nvcc: {ver.strip().splitlines()[-1]}", flush=True)
    card = bench.card_info()
    if card is None:
        fail("nvidia-smi gave no card name and power limit")
    print(card, flush=True)
    _, b = build.load(mk.KERNEL_SOURCE)
    print(f"[chip_smoke] built {b.path.name} in {b.seconds:.1f} s", flush=True)
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[chip_smoke] ptxas: {line.strip()}", flush=True)

    # --- phase 2: kernel against the plain version on the card
    print("[chip_smoke] bounds: rmse <= 2e-2, divergent (max channel err > 0.05) <= 1%, "
          "|rays - ref| <= max(2e-3 * ref, 8)", flush=True)
    launches0 = mk.LAUNCHES

    def diffuse_cam(aspect):
        return Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=aspect,
                              device=dev)

    def rtiow_cam(aspect):
        return Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=aspect,
                              aperture=0.1, focus_dist=10.0, device=dev)

    def check(label, packed, cam, mode, kw, plain_reps=0):
        """Kernel vs plain on the same inputs; with plain_reps, also times
        both (kernel: 5 calls). Returns (max_abs, ms, plain_ms, image, rays)."""
        if packed.mode != mode:
            fail(f"{label}: expected {mode} mode, got {packed.mode}")
        run = functools.partial(mk.render_image_kernel, packed, cam, **kw)
        plain = functools.partial(mk.render_image_plain, packed, cam, **kw)
        if plain_reps:
            (img, rays), ms = timed(run, reps=5)
            (ref, ref_rays), plain_ms = timed(plain, reps=plain_reps)
            print(f"[chip_smoke] {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})",
                  flush=True)
        else:
            (img, rays), ms, plain_ms = run(), None, None
            torch.cuda.synchronize()
            ref, ref_rays = plain()
            torch.cuda.synchronize()
        _, _, max_abs = compare(f"{label} kernel vs plain", ref, ref_rays, img, rays)
        return max_abs, ms, plain_ms, img, rays

    check("brute two_spheres 64x32 spp4 b4", mk.pack_scene(two_spheres_scene(device=dev)),
          diffuse_cam(2.0), "brute", dict(width=64, height=32, spp=4, max_bounces=4, seed=5))
    check("brute rtiow(grid=4) 64x32 spp4 b6 lens",
          mk.pack_scene(rtiow_final_scene(grid=4, device=dev)), rtiow_cam(2.0), "brute",
          dict(width=64, height=32, spp=4, max_bounces=6, seed=7, lens=True))

    rtiow = rtiow_final_scene(device=dev)
    kw = dict(width=320, height=180, spp=4, max_bounces=8, seed=0, lens=True)
    images = {
        mode: check(f"{mode} rtiow 320x180 spp4 b8", mk.pack_scene(rtiow, worklist),
                    rtiow_cam(320 / 180), mode, kw, plain_reps=2)[3:]
        for mode, worklist in (("grid", "auto"), ("brute", False))
    }
    compare("rtiow 320x180 kernel grid vs kernel worklist=False", *images["brute"], *images["grid"])

    # each mode at the frame the main path gives it (bench: grid; render CLI: brute)
    w, h = bench.FULL[:2]
    stats = {}
    for mode, label, scene, cam, extra in (
        ("grid", "grid rtiow 1920x1080 spp2 b8 lens", rtiow, rtiow_cam(w / h),
         dict(spp=2, lens=True)),
        ("brute", "brute two_spheres 1920x1080 spp4 b8", two_spheres_scene(device=dev),
         diffuse_cam(w / h), dict(spp=4)),
    ):
        max_abs, ms, plain_ms, _, _ = check(
            label, mk.pack_scene(scene), cam, mode,
            dict(width=w, height=h, max_bounces=8, seed=0, **extra), plain_reps=1)
        stats[mode] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    if mk.LAUNCHES <= launches0:
        fail("LAUNCHES did not increase in phase 2")
    print(f"[chip_smoke] phase 2 ok: {mk.LAUNCHES - launches0} kernel launches", flush=True)

    # --- phase 3: the main path (benchmark + render CLI), counts from zero
    os.makedirs(OUT_DIR, exist_ok=True)
    mk.LAUNCHES = 0
    for k in mk.LAUNCHES_BY_MODE:
        mk.LAUNCHES_BY_MODE[k] = 0
    t0 = time.perf_counter()
    result, img = bench.run_bench(quick=False, frames=3, device="cuda")
    png = os.path.join(OUT_DIR, "diffuse_1080p.png")
    cli_main(["render", "--scene", "diffuse", "--width", "1920", "--height", "1080",
              "--spp", "16", "--device", "cuda", "--out", png])
    torch.cuda.synchronize()
    counts = dict(mk.LAUNCHES_BY_MODE)
    print(f"[chip_smoke] main path took {time.perf_counter() - t0:.1f} s; launches {counts}",
          flush=True)
    print(json.dumps(result), flush=True)
    spp = bench.FULL[2]
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        fail(f"bench image has shape {tuple(img.shape)} or non-finite pixels")
    per_frame = result["rays"] // result["frames"]
    if per_frame < w * h * spp:
        fail(f"bench traced {per_frame} rays per frame, fewer than one per sample")
    if not os.path.isfile(png):
        fail("render CLI wrote no PNG")
    missing = [m for m, n in counts.items() if n == 0]
    if missing:
        fail(f"kernel modes never launched on the main path: {missing}")

    kernels = [
        dict(name=f"sphere_megakernel[{m}]", route="cuda", source=SOURCE, replaces=REPLACES,
             launches=counts[m], **stats[m])
        for m in ("grid", "brute")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
