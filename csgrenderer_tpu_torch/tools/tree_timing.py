"""Compare trees of the port on one card in one run: the sphere kernel's
frames (kernel rows 1-3), the RTIOW bench frame, the realtime loop and the
shard canary's launch path (kernel row 9).

    python -m csgrenderer_tpu_torch.tools.tree_timing --trees parent=DIR,change=DIR [--out DIR]
    PYTHONPATH=DIR python csgrenderer_tpu_torch/tools/tree_timing.py --label NAME [--json FILE]

``--trees`` takes ``label=directory`` pairs, each directory the root of a
tree that holds ``csgrenderer_tpu_torch`` (e.g. an unpacked ``git
archive`` of a commit). It builds every tree's sphere kernel and canary at
once (one process per tree, each running nvcc for its own sources), then
measures each tree in its own process, twice, in the order given and then
in reverse (parent, change, change, parent for two trees), and prints each
measurement beside the first tree's. ``--label`` measures the package found
on ``sys.path`` and writes one JSON file; ``--trees`` runs it so.

Measured per tree, CUDA events unless named otherwise:

- kernel rows 1-3 at the frames of PERF.md's kernel table (grid: the RTIOW
  final scene at 1920x1080, 2 spp, 8 bounces, lens; brute: the two-sphere
  scene at 1920x1080, 4 spp, 8 bounces; brute-nee and grid-nee: night and
  night488 at 960x540, 2 spp, 6 bounces, black sky): the median ms of
  ``REPS`` back-to-back launches after a warm-up, and the sha256 of the
  last frame's f32 bytes with its ray count, so the trees' images are held
  to each other bit for bit;
- the RTIOW bench frame (``bench.run_bench``: 1920x1080, 64 spp, 8 bounces,
  5 frames): Mrays/s and frame times;
- the realtime loop (``PathTraceRenderer(rtiow_final_scene(),
  advance_samples=True)`` at 1280x720, 2 spp, lens): the host's time to
  enqueue a frame and the time per frame drained (host clock, 200 frames),
  and ``App.run``'s frames/s with two frames in flight and every frame
  read back (three runs);
- the canary wrapper and ``torch.mul(x, 2.0)`` on one [8, 128] f32 tensor,
  in turns (kernel, mul, kernel, mul, ...; 5 rounds of 1,000 calls each):
  per-call time by CUDA events over each loop.

It uses only the entry points every tree of the port has.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPS = 15  # timed launches per kernel frame
CANARY_CALLS, CANARY_ROUNDS = 1000, 5
REALTIME_FRAMES, REALTIME_RUNS = 200, 3
KERNEL_SOURCES = ("sphere_megakernel", "shard_canary")


def _frames(dev):
    """label -> (packed scene, camera, kwargs): the kernel table's frames."""
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.models import night_scene, rtiow_final_scene, two_spheres_scene

    def cam(eye, at, vfov, aspect, **kw):
        return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect, device=dev, **kw)

    night = dict(width=960, height=540, spp=2, max_bounces=6, seed=0, sky="black", nee=True)
    night_cam = cam((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), 32.0, 960 / 540)
    return {
        "grid rtiow 1920x1080 spp2 b8 lens": (
            mk.pack_scene(rtiow_final_scene(device=dev)),
            cam((13, 2, 3), (0, 0, 0), 20.0, 1920 / 1080, aperture=0.1, focus_dist=10.0),
            dict(width=1920, height=1080, spp=2, max_bounces=8, seed=0, lens=True)),
        "brute two_spheres 1920x1080 spp4 b8": (
            mk.pack_scene(two_spheres_scene(device=dev)),
            cam((0, 0, 0), (0, 0, -1), 90.0, 1920 / 1080),
            dict(width=1920, height=1080, spp=4, max_bounces=8, seed=0)),
        "brute-nee night 960x540 spp2 b6": (mk.pack_scene(night_scene(device=dev)), night_cam,
                                            night),
        "grid-nee night488 960x540 spp2 b6": (mk.pack_scene(night_scene(grid=11, device=dev)),
                                              night_cam, night),
    }


def _events_ms(fn, reps):
    """ms per call of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _median_ms(fn, reps):
    """(last result, median ms, each call's ms) over ``reps`` back-to-back
    calls, each between its own pair of CUDA events."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for i in range(reps):
        out = fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    each = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return out, sorted(each)[reps // 2], each


def measure(label: str) -> dict:
    """Every measurement of the module docstring for the package on sys.path."""
    import torch

    import csgrenderer_tpu_torch
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import shard_canary as sc
    from csgrenderer_tpu_torch.models import rtiow_final_scene
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    if not torch.cuda.is_available():
        raise SystemExit("tree_timing needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    out = dict(label=label, package=str(Path(csgrenderer_tpu_torch.__file__).parent),
               card=bench.card_info(), frames={})
    sphere = build.load("sphere_megakernel")[1]
    out["ptxas"] = [line.strip() for line in sphere.log.splitlines()
                    if "registers" in line or "spill" in line or "entry function" in line]
    for name, (packed, cam, kw) in _frames(dev).items():
        run = functools.partial(mk.render_image_kernel, packed, cam, **kw)
        run()  # warm-up
        torch.cuda.synchronize()
        (img, rays), ms, each = _median_ms(run, REPS)
        digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
        out["frames"][name] = dict(ms=ms, each_ms=each, sha256=digest, rays=int(rays))

    result, _ = bench.run_bench(quick=False, frames=5, device="cuda")
    out["bench_rtiow"] = dict(mrays_s=result["value"], frame_times_s=result["frame_times_s"],
                              p50_16spp_ms=result["p50_frame_ms_16spp"])

    scene = rtiow_final_scene(device=dev)
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=1280 / 720,
                         aperture=0.1, focus_dist=10.0, device=dev)
    r = PathTraceRenderer(scene, cam, RenderConfig(width=1280, height=720, spp=2, lens=True),
                          advance_samples=True)
    r.draw_frame(0.0)  # warm-up
    enqueue, drained, fps = [], [], []
    for _ in range(REALTIME_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(REALTIME_FRAMES):
            r.draw_frame_async(i / 60.0)
        enqueue.append((time.perf_counter() - t0) * 1e3 / REALTIME_FRAMES)
        torch.cuda.synchronize()
        drained.append((time.perf_counter() - t0) * 1e3 / REALTIME_FRAMES)
    for _ in range(REALTIME_RUNS):
        app = App(width=1280, height=720, stats=StatsClock(emit=None),
                  frame_sink=lambda i, f: f.cpu().numpy() if isinstance(f, torch.Tensor) else f)
        app.swap_scene(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not app.run(max_frames=REALTIME_FRAMES, frames_in_flight=2, readback="full"):
            raise RuntimeError("the App loop failed")
        torch.cuda.synchronize()
        fps.append(REALTIME_FRAMES / (time.perf_counter() - t0))
    out["realtime_rtiow_720p"] = dict(enqueue_ms=enqueue, drained_ms=drained, fps=fps)

    x = torch.arange(1024, dtype=torch.float32, device=dev).reshape(sc.SHAPE) * 0.37 - 11.0
    if not torch.equal(sc.scale2_kernel(x), torch.mul(x, 2.0)):
        raise RuntimeError("the canary kernel is not torch.mul(x, 2.0)")
    kernel_us, mul_us = [], []
    for _ in range(CANARY_ROUNDS):
        kernel_us.append(_events_ms(functools.partial(sc.scale2_kernel, x), CANARY_CALLS)[1] * 1e3)
        mul_us.append(_events_ms(functools.partial(torch.mul, x, 2.0), CANARY_CALLS)[1] * 1e3)
    out["canary"] = dict(kernel_us=kernel_us, mul_us=mul_us)
    return out


def _run_trees(trees: list[tuple[str, Path]], out_dir: Path) -> int:
    def env(root):
        return {**os.environ, "PYTHONPATH": str(root)}

    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from csgrenderer_tpu_torch.kernels import build\n"
         + "".join(f"build.load({name!r})\n" for name in KERNEL_SOURCES)],
        env=env(root)) for _, root in trees]
    if any(p.wait() for p in builds):
        print("[tree_timing] a tree's kernels did not build", flush=True)
        return 1
    print(f"[tree_timing] built {len(trees)} trees in {time.perf_counter() - t0:.1f} s (at once)",
          flush=True)
    results: dict[str, list[dict]] = {label: [] for label, _ in trees}
    for label, root in trees + trees[::-1]:
        path = out_dir / f"{label}.{len(results[label])}.json"
        rc = subprocess.call([sys.executable, os.path.abspath(__file__), "--label", label,
                              "--json", str(path)], env=env(root))
        if rc:
            print(f"[tree_timing] {label} failed ({rc})", flush=True)
            return rc
        results[label].append(json.loads(path.read_text()))

    def join(values, spec):
        return ", ".join(format(v, spec) for v in values)

    base_label = trees[0][0]
    base = results[base_label][0]
    print(f"[tree_timing] {base['card']}; each tree twice (order given, then reversed)",
          flush=True)
    ok = True
    for label, runs in results.items():
        for line in runs[0]["ptxas"]:
            print(f"[tree_timing] {label} ptxas: {line}", flush=True)
        for name, f0 in base["frames"].items():
            fr = [run["frames"][name] for run in runs]
            same = all((f["sha256"], f["rays"]) == (f0["sha256"], f0["rays"]) for f in fr)
            ok &= same
            base_ms = [run["frames"][name]["ms"] for run in results[base_label]]
            print(f"[tree_timing] {label} {name}: {join([f['ms'] for f in fr], '.4f')} ms "
                  f"({base_label} {join(base_ms, '.4f')}); image and rays "
                  f"{'equal to' if same else 'DIFFER from'} {base_label}'s ({fr[0]['rays']} rays)",
                  flush=True)
        for run in runs:
            b, rt, c = run["bench_rtiow"], run["realtime_rtiow_720p"], run["canary"]
            print(f"[tree_timing] {label} bench rtiow 1080p 64spp: {b['mrays_s']:.1f} Mrays/s "
                  f"(frames {join([t * 1e3 for t in b['frame_times_s']], '.3f')} ms; 16-spp p50 "
                  f"{b['p50_16spp_ms']:.3f} ms); realtime 720p spp2: enqueue "
                  f"{join(rt['enqueue_ms'], '.4f')} ms, drained {join(rt['drained_ms'], '.4f')} "
                  f"ms per frame, App.run {join(rt['fps'], '.1f')} frames/s; canary "
                  f"{join(c['kernel_us'], '.2f')} us vs torch.mul {join(c['mul_us'], '.2f')} us "
                  "per call", flush=True)
    summary = out_dir / "summary.json"
    summary.write_text(json.dumps(results))
    print(f"[tree_timing] {'every image equal' if ok else 'IMAGES DIFFER'}; {summary}", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="label=directory,... (the first is the baseline)")
    ap.add_argument("--label", help="measure the package on sys.path under this label")
    ap.add_argument("--json", help="with --label: write the result here")
    ap.add_argument("--out", default="_scratch/tree_timing", help="with --trees: results")
    args = ap.parse_args(argv)
    if args.label:
        res = measure(args.label)
        text = json.dumps(res)
        if args.json:
            Path(args.json).write_text(text)
        print(text, flush=True)
        return 0
    if not args.trees:
        ap.error("give --trees or --label")
    trees = []
    for item in args.trees.split(","):
        label, _, root = item.partition("=")
        if not (Path(root) / "csgrenderer_tpu_torch").is_dir():
            ap.error(f"{root} holds no csgrenderer_tpu_torch")
        trees.append((label, Path(root).resolve()))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    return _run_trees(trees, out_dir)


if __name__ == "__main__":
    sys.exit(main())
