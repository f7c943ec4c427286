"""Compare trees of the port on one card in one run: the sphere kernel's
frames (kernel rows 1-2), the RTIOW bench frame, the realtime loop and the
shard canary's launch path (kernel row 9); its NEE frames (row 3), the
night488 frame at 64 spp, the same frames without NEE as a bound, and the
night488 bench frame; the tape kernel's frames (rows
4a-4c, many-object scenes around the cluster tree's threshold) and the
deepcsg, csgnight and manyobjects bench frames; the mesh
kernel's frames (row 5, its four modes) and the mesh and meshnight bench
frames; the mesh face-count ladder; the denoise path (kernel row 10,
the renderer's denoise step and the denoised realtime loop); and the five
offline cells' frames through their kernels' stats instantiations.

    python -m csgrenderer_tpu_torch.tools.tree_timing --trees parent=DIR,change=DIR [--out DIR]
        [--groups sphere,nee,tape,mesh,ladder,denoise,stats]
    PYTHONPATH=DIR python csgrenderer_tpu_torch/tools/tree_timing.py --label NAME [--json FILE]

``--trees`` takes ``label=directory`` pairs, each directory the root of a
tree that holds ``csgrenderer_tpu_torch`` (e.g. an unpacked ``git
archive`` of a commit). It builds every tree's kernels at once (one process
per tree, each running nvcc for its own sources), then
measures each tree in its own process, twice, in the order given and then
in reverse (parent, change, change, parent for two trees), and prints each
measurement beside the first tree's. ``--label`` measures the package found
on ``sys.path`` and writes one JSON file; ``--trees`` runs it so.

Measured per tree, CUDA events unless named otherwise, for the groups
``--groups`` names (all of them but stats by default):

- sphere: kernel rows 1-2 at the frames of PERF.md's kernel table (grid:
  the RTIOW final scene at 1920x1080, 2 spp, 8 bounces, lens; brute: the
  two-sphere scene at 1920x1080, 4 spp, 8 bounces);
- nee: kernel row 3 (brute-nee and grid-nee: night and night488 at
  960x540, 2 spp, 6 bounces, black sky), night488 at 64 spp (the
  night-nee-540p64 cell's frame), and the grid-nee frames rendered with
  ``nee=False`` (another image, with one walk a segment: a bound on what
  the NEE kernel's walks could come to);
- tape: rows 4a-4c (config5 at t = 1.0, 1920x1080, 2 spp, 5 bounces,
  clustered, global and the audit at k = 4; csgnight at 960x540, 2 spp, 6
  bounces, black sky, clustered-nee, global-nee and audit-nee), and
  many_objects_scene(n) for n of ``MANY_OBJECTS`` at the manyobjects-720p16
  cell's frame (1280x720, 16 spp, 8 bounces, camera (0, 7, 9) -> (0, 0.4,
  0)): 99 is the cell's scene, the others cuts around the cluster tree's
  threshold (``tape_kernel.TREE_MIN_CLUSTERS`` bounded clusters);
- mesh: row 5 (mesh_demo_scene(2) forced brute and mesh_demo_scene(4) grid
  at 1280x720, 2 spp, 6 bounces; tests/test_nee.py's 82-face lamp scene
  brute-nee and mesh_night_scene() grid-nee at 960x540, 2 spp, 6 bounces,
  black sky);
- ladder: chip_smoke.py's face-count ladder (mesh_demo_scene at subdiv 2-6,
  962 to 245,762 faces) at 1280x720, 16 spp, 6 bounces (``LADDER_REPS``
  launches each);
- denoise: the a-trous filter (``render/denoise.atrous_denoise``) on the
  RTIOW final scene's 2-spp lens frame and its AOVs (the plain brute cast,
  the same inputs in every tree) at 1280x720 and 1920x1080, 4 passes, and
  at 997x563, 5 passes; and the renderer's denoise step
  (``PathTraceRenderer.denoise_image``: the AOV cast and the 4 passes) at
  1280x720;
- stats (only when named: trees whose kernels have a stats mode,
  ``kernels.build.STATS_EVERY``):
  the frames of the five offline cells (rtiow 1920x1080, 64 spp, lens;
  deepcsg 1920x1080, 64 spp; night488 960x540, 64 spp, NEE; the
  102,402-face mesh and the 99-object scene at 1280x720, 16 spp), each
  launched plain and through its kernel's stats instantiation (every
  launch a stats launch, under ``profiling.recording()``), the stats
  frame's image and segments held to the plain frame's and its stats
  block reported beside them;

each frame: the median ms of ``REPS`` back-to-back launches after a
warm-up, and the sha256 of the last frame's f32 bytes with its ray count
(and the audit's dropped spans, the NEE frames' shadow rays, or the mesh
frames' triangle tests), so the trees' images are held to each other bit
for bit;

- the bench frames (``bench.run_bench``, 5 frames each): rtiow (sphere
  group; 1920x1080, 64 spp, 8 bounces), night488 (nee group; 960x540, 64
  spp, 6 bounces), deepcsg, csgnight and manyobjects
  (tape), mesh and meshnight (mesh): Mrays/s and frame times;
- the realtime loop (``PathTraceRenderer(rtiow_final_scene(),
  advance_samples=True)`` at 1280x720, 2 spp, lens): the host's time to
  enqueue a frame and the time per frame drained (host clock, 200 frames),
  and ``App.run``'s frames/s with two frames in flight and every frame
  read back (three runs); with the denoise group, the same loop with
  ``denoise=True`` (50 frames a run: enqueue and drained ms);
- the canary wrapper and ``torch.mul(x, 2.0)`` on one [8, 128] f32 tensor,
  in turns (kernel, mul, kernel, mul, ...; 5 rounds of 1,000 calls each):
  per-call time by CUDA events over each loop (the last two: sphere group).

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
LADDER_REPS = 5  # timed launches per ladder rung
CANARY_CALLS, CANARY_ROUNDS = 1000, 5
REALTIME_FRAMES, REALTIME_RUNS = 200, 3
DENOISED_FRAMES = 50  # frames a run of the denoised realtime loop
GROUPS = ("sphere", "nee", "tape", "mesh", "ladder", "denoise", "stats")
KERNEL_SOURCES = ("sphere_megakernel", "shard_canary", "tape_kernel", "trimesh_kernel", "atrous")
BENCH_SCENES = {"sphere": ("rtiow",), "nee": ("night488",),
                "tape": ("deepcsg", "csgnight", "manyobjects"), "mesh": ("mesh", "meshnight"),
                "ladder": (), "denoise": (), "stats": ()}
STATS_SUFFIX = " [stats]"  # a stats group frame through the stats instantiation
LADDER = ((2, 3), (3, 3), (4, 3), (5, 3), (5, 5), (6, 3))  # (subdiv, spheres) of mesh_demo_scene
MANY_OBJECTS = (8, 12, 16, 99)  # objects of many_objects_scene in the tape group


def _frames(dev, groups):
    """label -> (render, reps): the kernel table's frames of ``groups``,
    each a function of no arguments returning (image, rays[, dropped
    spans, shadow rays or triangle tests])."""
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import tape_kernel as tk
    from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
    from csgrenderer_tpu_torch.models import (animated_csg_scene, csg_night_scene,
                                              many_objects_scene, mesh_demo_scene,
                                              mesh_night_scene, night_scene, rtiow_final_scene,
                                              two_spheres_scene)
    from csgrenderer_tpu_torch.render.trimesh import concat_meshes, icosphere, quad
    from csgrenderer_tpu_torch.scene import Material

    def cam(eye, at, vfov, aspect, **kw):
        return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect, device=dev, **kw)

    def frame(render, scene, camera, reps=REPS, **kw):
        return functools.partial(render, scene, camera, **kw), reps

    frames = {}
    night = dict(width=960, height=540, spp=2, max_bounces=6, seed=0, sky="black", nee=True)
    sphere = functools.partial(frame, mk.render_image_kernel)
    if "sphere" in groups:
        frames.update({
            "grid rtiow 1920x1080 spp2 b8 lens": sphere(
                mk.pack_scene(rtiow_final_scene(device=dev)),
                cam((13, 2, 3), (0, 0, 0), 20.0, 1920 / 1080, aperture=0.1, focus_dist=10.0),
                width=1920, height=1080, spp=2, max_bounces=8, seed=0, lens=True),
            "brute two_spheres 1920x1080 spp4 b8": sphere(
                mk.pack_scene(two_spheres_scene(device=dev)),
                cam((0, 0, 0), (0, 0, -1), 90.0, 1920 / 1080),
                width=1920, height=1080, spp=4, max_bounces=8, seed=0),
        })
    if "nee" in groups:
        def nee(packed, camera, **kw):  # (image, rays, shadow rays)
            def run():
                counts = {}
                img, rays = mk.render_image_kernel(packed, camera, counts=counts, **kw)
                return img, rays, counts["shadow_rays"]
            return run, REPS

        night_cam = cam((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), 32.0, 960 / 540)
        night488 = mk.pack_scene(night_scene(grid=11, device=dev))
        no_nee = {**night, "nee": False}
        frames.update({
            "brute-nee night 960x540 spp2 b6": nee(mk.pack_scene(night_scene(device=dev)),
                                                   night_cam, **night),
            "grid-nee night488 960x540 spp2 b6": nee(night488, night_cam, **night),
            "grid-nee night488 960x540 spp64 b6": nee(night488, night_cam,
                                                      **{**night, "spp": 64}),
            "bound: grid night488 nee=False 960x540 spp2 b6": sphere(night488, night_cam,
                                                                     **no_nee),
            "bound: grid night488 nee=False 960x540 spp64 b6": sphere(
                night488, night_cam, **{**no_nee, "spp": 64}),
        })
    if "tape" in groups:
        tape = functools.partial(frame, tk.render_image_tape_kernel)
        graph5, animate5 = animated_csg_scene(8)
        tape5 = animate5(graph5.compile(k=4, device=dev), 1.0)
        cam5 = cam((0, 2.0, 7.0), (0.5, 0, 0), 40.0, 1920 / 1080)
        kw5 = dict(width=1920, height=1080, spp=2, max_bounces=5, seed=0)
        csg_cam = cam((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), 38.0, 960 / 540)
        night_tape = csg_night_scene().compile(k=4, device=dev)
        frames.update({
            "4a clustered config5 1920x1080 spp2 b5": tape(tk.pack_program(tape5), cam5, **kw5),
            "4a global config5 1920x1080 spp2 b5": tape(tk.pack_program(tape5, False), cam5,
                                                        **kw5),
            "4b audit config5 k4 1920x1080 spp2 b5": tape(tk.pack_program(tape5), cam5,
                                                          with_overflow=True, **kw5),
            "4b audit-nee csgnight k4 960x540 spp2 b6": tape(tk.pack_program(night_tape), csg_cam,
                                                             with_overflow=True, **night),
            "4c clustered-nee csgnight 960x540 spp2 b6": tape(tk.pack_program(night_tape),
                                                              csg_cam, **night),
            "4c global-nee csgnight 960x540 spp2 b6": tape(tk.pack_program(night_tape, False),
                                                           csg_cam, **night),
        })
        many_cam = cam((0, 7.0, 9.0), (0, 0.4, 0), 45.0, 1280 / 720)
        for n in MANY_OBJECTS:
            frames[f"4a manyobjects({n}) 1280x720 spp16 b8"] = tape(
                tk.pack_program(many_objects_scene(n).compile(k=4, device=dev)), many_cam,
                width=1280, height=720, spp=16, max_bounces=8, seed=0)
    if "mesh" in groups or "ladder" in groups:
        def mesh(packed, camera, reps=REPS, **kw):  # (image, rays, triangle tests)
            def run():
                counts = {}
                img, rays = tm.render_image_mesh_kernel(packed, camera, counts=counts, **kw)
                return img, rays, counts["tri_tests"]
            return run, reps

        kwm = dict(width=1280, height=720, spp=2, max_bounces=6, seed=0)
        cam_m = cam((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), 45.0, 1280 / 720)
    if "mesh" in groups:
        lamp82 = concat_meshes(
            icosphere((0, 0.7, -3), 0.7, Material.lambertian((0.6, 0.3, 0.3)), 1, dev),
            quad((-0.6, 2.2, -3.4), (0.6, 2.2, -3.4), (0.6, 2.2, -2.4), (-0.6, 2.2, -2.4),
                 Material.emissive((12.0, 10.0, 8.0)), dev))
        frames.update({
            "5 brute mesh_demo_scene(2) 1280x720 spp2 b6": mesh(
                tm.pack_mesh(mesh_demo_scene(2, device=dev), False), cam_m, **kwm),
            "5 grid mesh_demo_scene(4) 1280x720 spp2 b6": mesh(
                tm.pack_mesh(mesh_demo_scene(4, device=dev)), cam_m, **kwm),
            "5 brute-nee lamp82 960x540 spp2 b6": mesh(
                tm.pack_mesh(lamp82), cam((0, 1.4, 1.6), (0, 0.6, -3), 50.0, 960 / 540),
                **night),
            "5 grid-nee meshnight 960x540 spp2 b6": mesh(
                tm.pack_mesh(mesh_night_scene(device=dev)),
                cam((0, 1.8, 2.4), (0.0, 0.7, -2.6), 45.0, 960 / 540), **night),
        })
    if "denoise" in groups:
        frames.update(_denoise_frames(dev, cam))
    if "stats" in groups:
        frames.update(_stats_frames(dev, cam))
    if "ladder" in groups:
        for sub, spheres in LADDER:
            packed = tm.pack_mesh(mesh_demo_scene(sub, spheres, device=dev))
            frames[f"ladder {packed.mesh.num_faces} faces 1280x720 spp16 b6"] = mesh(
                packed, cam_m, LADDER_REPS, **{**kwm, "spp": 16})
    return frames


def _stats_frames(dev, cam):
    """The stats group's frames: each cell's frame plain and, named with
    ``STATS_SUFFIX``, through its kernel's stats instantiation (every
    launch a stats launch), returning (image, rays[, stats words])."""
    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import tape_kernel as tk
    from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
    from csgrenderer_tpu_torch.models import (animated_csg_scene, many_objects_scene,
                                              mesh_demo_scene, night_scene, rtiow_final_scene)
    from csgrenderer_tpu_torch.utils import profiling

    build.STATS_EVERY = 1  # in this process, every launch that can count its stats does

    graph5, animate5 = animated_csg_scene(8)
    cells = {
        "rtiow 1920x1080 spp64 b8 lens": (
            mk.render_image_kernel, mk.pack_scene(rtiow_final_scene(device=dev)),
            cam((13, 2, 3), (0, 0, 0), 20.0, 1920 / 1080, aperture=0.1, focus_dist=10.0),
            dict(width=1920, height=1080, spp=64, max_bounces=8, lens=True)),
        "deepcsg 1920x1080 spp64 b5": (
            tk.render_image_tape_kernel,
            tk.pack_program(animate5(graph5.compile(k=4, device=dev), 1.0)),
            cam((0, 2.0, 7.0), (0.5, 0, 0), 40.0, 1920 / 1080),
            dict(width=1920, height=1080, spp=64, max_bounces=5)),
        "night488 960x540 spp64 b6 nee": (
            mk.render_image_kernel, mk.pack_scene(night_scene(grid=11, device=dev)),
            cam((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), 32.0, 960 / 540),
            dict(width=960, height=540, spp=64, max_bounces=6, sky="black", nee=True)),
        "mesh102k 1280x720 spp16 b6": (
            tm.render_image_mesh_kernel, tm.pack_mesh(mesh_demo_scene(5, 5, device=dev)),
            cam((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), 45.0, 1280 / 720),
            dict(width=1280, height=720, spp=16, max_bounces=6)),
        "manyobjects(99) 1280x720 spp16 b8": (
            tk.render_image_tape_kernel,
            tk.pack_program(many_objects_scene(99).compile(k=4, device=dev)),
            cam((0, 7.0, 9.0), (0, 0.4, 0), 45.0, 1280 / 720),
            dict(width=1280, height=720, spp=16, max_bounces=8)),
    }
    frames = {}
    for name, (render, packed, camera, kw) in cells.items():
        def plain(render=render, packed=packed, camera=camera, kw=kw):
            return render(packed, camera, seed=0, **kw)

        def stats(render=render, packed=packed, camera=camera, kw=kw, name=name):
            counts = {}
            with profiling.recording():
                img, rays = render(packed, camera, seed=0, counts=counts, **kw)
            if "stats" not in counts:
                raise RuntimeError(f"{name}: the launch ran no stats instantiation")
            return (img, rays, *counts["stats"])

        frames[name] = (plain, REPS)
        frames[name + STATS_SUFFIX] = (stats, REPS)
    return frames


def _denoise_frames(dev, cam):
    """The denoise group's frames: each a function of no arguments returning
    (image,)."""
    from csgrenderer_tpu_torch.app import PathTraceRenderer
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.models import rtiow_final_scene
    from csgrenderer_tpu_torch.render import denoise, render_aovs
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    scene = rtiow_final_scene(device=dev)
    packed = mk.pack_scene(scene)
    frames = {}
    for w, h, passes in ((1280, 720, 4), (1920, 1080, 4), (997, 563, 5)):
        c = cam((13, 2, 3), (0, 0, 0), 20.0, w / h, aperture=0.1, focus_dist=10.0)
        raw, _ = mk.render_image_kernel(packed, c, w, h, spp=2, max_bounces=8, seed=0, lens=True)
        aovs = render_aovs(scene.nearest_hit, c, w, h, row_chunk=180)
        frames[f"10 atrous {passes} passes rtiow {w}x{h}"] = (
            lambda raw=raw, aovs=aovs, n=passes: (denoise.atrous_denoise(raw, aovs, n),), REPS)
    c = cam((13, 2, 3), (0, 0, 0), 20.0, 1280 / 720, aperture=0.1, focus_dist=10.0)
    r = PathTraceRenderer(scene, c, RenderConfig(width=1280, height=720, spp=2, lens=True,
                                                 denoise=True), advance_samples=True)
    raw, _ = r._render(0.0)
    frames["denoise_image rtiow 1280x720 (AOV cast, 4 passes)"] = (
        lambda: (r.denoise_image(raw, 0.0),), REPS)
    return frames


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


def measure(label: str, groups=GROUPS) -> dict:
    """Every measurement of the module docstring for the package on
    sys.path, for ``groups``."""
    import torch

    import csgrenderer_tpu_torch
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import shard_canary as sc
    from csgrenderer_tpu_torch.models import rtiow_final_scene
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    if not torch.cuda.is_available():
        raise SystemExit("tree_timing needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    out = dict(label=label, package=str(Path(csgrenderer_tpu_torch.__file__).parent),
               card=bench.card_info(), frames={})
    out["ptxas"] = [f"{name}: {line.strip()}" for name in KERNEL_SOURCES
                    for line in build.load(name)[1].log.splitlines()
                    if "registers" in line or "spill" in line or "entry function" in line]
    for name, (run, reps) in _frames(dev, groups).items():
        run()  # warm-up
        torch.cuda.synchronize()
        (img, *counts), ms, each = _median_ms(run, reps)
        digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
        out["frames"][name] = dict(ms=ms, each_ms=each, sha256=digest,
                                   rays=[int(c) for c in counts])
        if name.endswith(STATS_SUFFIX):  # held to the plain frame measured just before it
            plain = out["frames"][name[:-len(STATS_SUFFIX)]]
            if (digest, int(counts[0])) != (plain["sha256"], plain["rays"][0]):
                raise RuntimeError(f"{name}: the stats frame differs from the plain frame")

    out["bench"] = {}
    for scene in (s for g in groups for s in BENCH_SCENES[g]):
        result, _ = bench.run_bench(scene=scene, quick=False, frames=5, device="cuda")
        out["bench"][scene] = dict(mrays_s=result["value"], frame_times_s=result["frame_times_s"],
                                   p50_16spp_ms=result.get("p50_frame_ms_16spp"))
    if "denoise" in groups:
        cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=1280 / 720,
                             aperture=0.1, focus_dist=10.0, device=dev)
        r = PathTraceRenderer(rtiow_final_scene(device=dev), cam,
                              RenderConfig(width=1280, height=720, spp=2, lens=True, denoise=True),
                              advance_samples=True)
        r.draw_frame(0.0)  # warm-up
        enqueue, drained = [], []
        for _ in range(REALTIME_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DENOISED_FRAMES):
                r.draw_frame_async(i / 60.0)
            enqueue.append((time.perf_counter() - t0) * 1e3 / DENOISED_FRAMES)
            torch.cuda.synchronize()
            drained.append((time.perf_counter() - t0) * 1e3 / DENOISED_FRAMES)
        out["realtime_denoised_720p"] = dict(enqueue_ms=enqueue, drained_ms=drained)
    if "sphere" not in groups:
        return out

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


def _run_trees(trees: list[tuple[str, Path]], out_dir: Path, groups) -> int:
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
                              "--json", str(path), "--groups", ",".join(groups)], env=env(root))
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
                  f"({base_label} {join(base_ms, '.4f')}); image and counts "
                  f"{'equal to' if same else 'DIFFER from'} {base_label}'s ({fr[0]['rays']})",
                  flush=True)
        for run in runs:
            for scene, b in run["bench"].items():
                base_mrays = [r["bench"][scene]["mrays_s"] for r in results[base_label]]
                print(f"[tree_timing] {label} bench {scene}: {b['mrays_s']:.1f} Mrays/s "
                      f"({base_label} {join(base_mrays, '.1f')}; frames "
                      f"{join([t * 1e3 for t in b['frame_times_s']], '.3f')} ms)", flush=True)
            if "realtime_denoised_720p" in run:
                rt = run["realtime_denoised_720p"]
                print(f"[tree_timing] {label} realtime denoised 720p spp2 4 passes: enqueue "
                      f"{join(rt['enqueue_ms'], '.4f')} ms, drained "
                      f"{join(rt['drained_ms'], '.4f')} ms per frame", flush=True)
            if "canary" not in run:
                continue
            rt, c = run["realtime_rtiow_720p"], run["canary"]
            print(f"[tree_timing] {label} realtime 720p spp2: enqueue "
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
    ap.add_argument("--groups", default=",".join(g for g in GROUPS if g != "stats"),
                    help=f"comma-separated, of {', '.join(GROUPS)}")
    args = ap.parse_args(argv)
    groups = tuple(g for g in args.groups.split(",") if g)
    if not groups or any(g not in GROUPS for g in groups):
        ap.error(f"--groups takes {', '.join(GROUPS)}")
    if args.label:
        res = measure(args.label, groups)
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
    return _run_trees(trees, out_dir, groups)


if __name__ == "__main__":
    sys.exit(main())
