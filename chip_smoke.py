"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a non-zero exit):

1. Environment: torch/CUDA/nvcc versions, the card and its power limit;
   build the three CUDA kernels from csgrenderer_tpu_torch/kernels/csrc
   (one nvcc each, started together) and print ptxas' registers and
   spills.
2. Each kernel against its plain torch version on the card. The sphere
   kernel in brute mode (two spheres; the small RTIOW scene) and grid mode
   (the RTIOW final scene at 320x180, 4 spp, 8 bounces), grid against
   forced brute, then each mode at the frame the main path gives it
   (1920x1080: grid on the RTIOW final scene, brute on the two-sphere
   scene). The tape kernel on config3 (BASELINE's 512x512, 16 spp, 6
   bounces), on config5 (the depth-8 animated CSG chain at t = 1.0) at the
   bench's 1920x1080 with 2 spp, 5 bounces, clustered and again global
   (and the two kernel images against each other), on
   many_objects_scene(99) at 640x360, 2 spp, 8 bounces (clustered; the
   global kernel is timed beside it and its image compared), on the render
   CLI's manyobjects tape and camera at its 1920x1080 with 2 spp, 8
   bounces, and on a rotated-box / glass-cylinder / half-space scene and a
   normal-map scene at 256x256. The NEE variants (black sky, next-event
   estimation toward the emissive spheres) at the night benchmarks' frame
   960x540 with 2 spp, 6 bounces: night_scene() in brute-nee mode,
   night_scene(grid=11) in grid-nee mode (each also timed in the other
   sphere mode and its kernel image compared), csg_night_scene() in
   clustered-nee mode and in global-nee mode (the two kernel images
   compared); and the blocker scene of tests/test_nee.py in grid-nee mode,
   whose umbra must be darker than a quarter of the open case. The mesh
   kernel: brute mode on an 82-face mesh (a subdiv-1 icosphere and
   mesh_demo_scene's floor) at 256x144, 4 spp, and on mesh_demo_scene(2)
   forced brute at 1280x720, 2 spp, 6 bounces (its image also against the
   grid kernel's); grid mode on mesh_demo_scene(4) at the same frame;
   brute-nee on tests/test_nee.py's 82-face lamp scene and grid-nee on
   mesh_night_scene() at 960x540, 2 spp, 6 bounces; grid-nee on the
   80-lamp scene of tests/test_nee.py; degenerate faces in both modes
   (never hit); and the face-count ladder of tools/bench_mesh.py (962 to
   245,762 faces), each rung packed (times printed) and kernel-timed at
   1280x720, 16 spp, 6 bounces, the last also against the plain walk at
   160x90, 1 spp. Kernel and plain version are timed with CUDA events at
   the frames the kernel line reports. Bounds
   (tests/test_kernels.py::compare): RMSE <= 2e-2, at most 1% of pixels
   off by more than 0.05 in any channel, rays within max(2e-3 * ref, 8).
3. The main path, counts from zero: the sphere benchmark (python -m
   csgrenderer_tpu_torch.bench) at 1920x1080, 64 spp, 8 bounces plus the
   16-spp p50; the config5 benchmark (--scene deepcsg) at 1920x1080, 64
   spp, 5 bounces plus the 16-spp p50; the night benchmarks (--scene
   night, night488, csgnight, meshnight) at 960x540, 64 spp, 6 bounces
   plus the 16-spp p50; the mesh benchmark (--scene mesh) at 1280x720, 16
   spp, 6 bounces; the render CLI on the two-sphere scene, on csg and on
   manyobjects, each at 1920x1080, 16 spp, and on csgnight and meshnight
   at 960x540, 16 spp. The sphere kernel's grid, brute, grid-nee and
   brute-nee modes, the tape kernel's clustered and clustered-nee modes
   and the mesh kernel's grid and grid-nee modes must have launched in
   this phase; the tape kernel's global and global-nee modes and the mesh
   kernel's brute and brute-nee modes must have launched in phase 2.

The last line of output is the device JSON; the line before it lists the
kernels with their launch counts, errors, times and bounds. There is no
CPU fallback: without CUDA the script exits non-zero.

Each kernel's ``bound_ms`` is the least time the card could take for the
frame's work: the larger of its FP32 operations over the card's FP32 rate
and its bytes (tables read once, outputs written once) over 3.35 TB/s.
Operations are counted from the kernel sources (``OPS`` below): one per
FP32 add, subtract, multiply, divide, square root, min, max, absolute
value or comparison, and one per cosf/sinf call; integer work, selects and
loads are not counted. Where the count depends on the data, only what must
run is counted, so each bound is a floor: a segment that is not known to
hit is counted as a miss, the grid walk's sphere tests are left out, a
tape candidate costs its first test only (the others are short-circuited
when it fails), and a tape segment walks the ops of one cluster, the
smallest, only if it surely hits (a candidate past the best t, or outside
(eps, cut), is skipped without a walk; a miss may walk none). A miss
under the black sky adds no sky. The NEE modes add, from the plain
version's run of the same frame (same RNG counters, so the same
decisions; ``integrator.trace_paths(counts=)``): a lamp sample (with the
cheaper cosine-lobe pdf) per Lambertian or glossy hit, a carried scatter
pdf per such vertex whose path goes on, a partner weight per MIS-weighted
lamp hit (the tape kernel's also matches the hit against every lamp), and
per shadow ray its setup and, when it reaches the lamp, every sphere test
of the brute pass (the grid walk's left out) or every leaf interval and
candidate test; an occluded shadow ray stops at its first occluder and
counts one sphere test or the first cluster's intervals. Shadow rays are
not segments (``rays``); their count is printed beside the bound. A mesh
segment tests every face (brute) or the globals, the walk's set-up and,
from the plain walk's counts of the same segments, the walks, voxel
visits and face tests it executes (grid); a mesh shadow ray that reaches
its lamp tests every face (brute) or the globals and the walk's set-up
(grid; its voxels are left out), an occluded one at least one face. The FP32
rate is 132 SMs x 128 lanes x the SM clock read under load, one operation
per lane per cycle: the kernels are built with -fmad=false, so no
multiply-add fuses two.
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
CSRC = "csgrenderer_tpu_torch/kernels/csrc"
KERNELS = {
    "sphere_megakernel": (f"{CSRC}/sphere_megakernel.cu", "csgrenderer_tpu/kernels/megakernel.py:775"),
    "tape_kernel": (f"{CSRC}/tape_kernel.cu", "csgrenderer_tpu/kernels/tape_kernel.py:744"),
    "trimesh_kernel": (f"{CSRC}/trimesh_kernel.cu",
                       "csgrenderer_tpu/kernels/trimesh_kernel.py:662"),
}  # the NEE modes are the same pallas_call with lamps (n_lights > 0; nee_lamps)
SMS, LANES = 132, 128
HBM_BYTES_PER_S = 3.35e12

# FP32 operations counted from the kernel sources (see the docstring's rule)
OPS = {
    "ray": 16,  # sphere kernel: o.d, o.o, d.d, 1/d.d
    "sphere_test": 20,  # sphere_t up to the disc test, plus the t < t_best test
    "segment": 12,  # 1/|d|, the unit direction, the hit test
    "miss": 17,  # add_sky
    "sphere_hit": 58,  # hit point, normal, front test, face-forward, a Lambertian scatter
    "leaf_transform": 63,  # o - pos and two quaternion rotations
    "interval": {0: 29, 1: 14, 2: 31, 3: 34},  # sphere, half-space, box, cylinder
    "candidate_test": 1,  # tj > eps (tj < cut, tj < t only where it holds)
    "walk_push": 4,  # below and above membership of one leaf at tj
    "tape_hit": 85,  # hit point, winner's normal to world, face-forward, scatter
    "attribution": {0: 47, 1: 40, 2: 69, 3: 61},  # per leaf: transform, score, best test
    "nee_sample": 107,  # lamp pick, cone sample, cosine-lobe pdf, lamp t, one test, MIS weight
    "carried_pdf": 18,  # cosine-lobe pdf of the scatter direction
    "partner": 24,  # the lamp's cone from the previous vertex, q / (q + 1)
    "lamp_match": 12,  # tape kernel, per lamp: |dist - r| and its test
    "shadow_lit": 6,  # throughput times the weight, added
    "mt_test": 52,  # mesh kernel: one Möller-Trumbore test, its t < t_best test
    "mesh_hit": 52,  # hit point, front test, face-forward, a Lambertian scatter
    "walk_setup": 35,  # the 3D walk's three slab ranges and its march test
    "walk_start": 51,  # the first voxel and each axis' step, tmax and td (a ray that enters)
    "walk_step": 8,  # one advance: the next crossing, its axis, the exit tests
    "tri_sample": 48,  # lamp pick, area sample, direction, cosine-lobe pdf, |cos_l|, tests
    "tri_weight": 13,  # q and the MIS-weighted contribution of a traced sample
    "tri_partner": 26,  # the lamp's q from the previous vertex, q / (q + 1)
    "tri_lamp_match": 10,  # per lamp: |plane distance| and its test
}


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


def sm_clock_under_load(fn, ms_per_call):
    """The SM clock (MHz) read by nvidia-smi while about 1.5 s of fn's
    launches are queued on the card."""
    import torch

    reps = max(2, int(1500 / max(ms_per_call, 1e-3)))
    for _ in range(reps):
        fn()
    time.sleep(0.3)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        mhz = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        mhz = None
    torch.cuda.synchronize()
    if mhz is None:
        fail("nvidia-smi gave no SM clock")
    return mhz


def hits_floor(rays, width, height, spp):
    """Segments that surely hit: every sample's path has at most one miss."""
    return max(int(rays) - width * height * spp, 0)


def miss_ops(sky):
    return 0 if sky == "black" else OPS["miss"]


def sphere_ops(n_brute, rays, width, height, spp, sky="rtiow"):
    hits = hits_floor(rays, width, height, spp)
    per_segment = OPS["ray"] + n_brute * OPS["sphere_test"] + OPS["segment"]
    return int(rays) * per_segment + hits * OPS["sphere_hit"] + (int(rays) - hits) * miss_ops(sky)


def leaf_interval_ops(packed, leaves):
    types = packed.tape.leaf_types
    return sum(OPS["leaf_transform"] + OPS["interval"][types[leaf]] for leaf in leaves)


def tape_ops(packed, rays, width, height, spp, sky="rtiow"):
    types = packed.tape.leaf_types
    min_lc = min(len(c_leaves) for _, c_leaves in packed.clusters)
    per_segment = (leaf_interval_ops(packed, range(len(types)))
                   + 2 * len(types) * OPS["candidate_test"] + OPS["segment"])
    # at least one walk (the taken candidate's) per hit, none per miss
    per_hit = OPS["tape_hit"] + sum(OPS["attribution"][t] for t in types) + min_lc * OPS["walk_push"]
    hits = hits_floor(rays, width, height, spp)
    return int(rays) * per_segment + hits * per_hit + (int(rays) - hits) * miss_ops(sky)


def mesh_ops(packed, rays, width, height, spp, sky="rtiow", walk=None):
    """A mesh frame's path-segment work: in brute mode every face tested
    per segment; in grid mode the globals, the walk's set-up, and from
    ``walk`` (the plain walk's counts of the same segments) the walks,
    voxel visits and face tests it executes."""
    hits = hits_floor(rays, width, height, spp)
    per_segment = OPS["segment"]
    ops = 0
    if packed.grid is None:
        per_segment += packed.mesh.num_faces * OPS["mt_test"]
    else:
        per_segment += packed.grid.n_globals * OPS["mt_test"] + OPS["walk_setup"]
        ops = (walk["walks"] * OPS["walk_start"] + walk["voxel_visits"] * OPS["walk_step"]
               + walk["face_tests"] * OPS["mt_test"])
    return (ops + int(rays) * per_segment + hits * OPS["mesh_hit"]
            + (int(rays) - hits) * miss_ops(sky))


def nee_ops(counts, per_shadow, clear_ops, occluded_ops, partner_ops,
            sample_ops=OPS["nee_sample"]):
    """The NEE work of a frame from the plain version's counts (ints):
    ``sample_ops`` per lamp sample, ``per_shadow`` ops set up every shadow
    ray, ``clear_ops`` test one that reaches its lamp, ``occluded_ops`` one
    that stops at an occluder."""
    occluded = counts["shadow_rays"] - counts["shadow_clear"]
    return (counts["nee_vertices"] * sample_ops + counts["carried_pdfs"] * OPS["carried_pdf"]
            + counts["mis_emission"] * partner_ops + counts["shadow_rays"] * per_shadow
            + counts["shadow_clear"] * (clear_ops + OPS["shadow_lit"])
            + occluded * occluded_ops)


def bound(ops, table_bytes, width, height, mhz):
    """(bound_ms, bound_by, ops, bytes) for one frame."""
    out_bytes = width * height * (3 * 4 + 4)  # rgb f32 + int32 rays
    total_bytes = table_bytes + out_bytes + 24 * 4
    ops_ms = ops / (SMS * LANES * mhz * 1e6) * 1e3
    bytes_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations", ops, total_bytes) if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes", ops, total_bytes)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.__main__ import main as cli_main
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import tape_kernel as tk
    from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
    from csgrenderer_tpu_torch.math import quaternion as quat
    from csgrenderer_tpu_torch.convert import mesh_from_numpy, sphere_scene_from_numpy
    from csgrenderer_tpu_torch.models import (
        animated_csg_scene,
        config3_csg_scene,
        csg_night_scene,
        many_objects_scene,
        mesh_demo_scene,
        mesh_night_scene,
        night_scene,
        rtiow_final_scene,
        two_spheres_scene,
    )
    from csgrenderer_tpu_torch.render.trimesh import concat_meshes, icosphere, quad
    from csgrenderer_tpu_torch.scene import Material, NodeArgument, SceneGraph

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
    t0 = time.perf_counter()
    builds = build.load_all()
    print(f"[chip_smoke] built {len(builds)} kernels in {time.perf_counter() - t0:.1f} s "
          f"(in parallel)", flush=True)
    for name, b in builds.items():
        print(f"[chip_smoke] {b.path.name}: nvcc {b.seconds:.1f} s", flush=True)
        for line in b.log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {name}: {line.strip()}", flush=True)

    # --- phase 2: each kernel against its plain version on the card
    print("[chip_smoke] bounds: rmse <= 2e-2, divergent (max channel err > 0.05) <= 1%, "
          "|rays - ref| <= max(2e-3 * ref, 8)", flush=True)
    mk_launches0, tk_launches0, tm_launches0 = mk.LAUNCHES, tk.LAUNCHES, tm.LAUNCHES
    tk_phase2, tm_phase2 = dict(tk.LAUNCHES_BY_MODE), dict(tm.LAUNCHES_BY_MODE)

    def cam_at(eye, at, vfov, aspect, **kw):
        return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect, device=dev, **kw)

    def diffuse_cam(aspect):
        return cam_at((0, 0, 0), (0, 0, -1), 90, aspect)

    def rtiow_cam(aspect):
        return cam_at((13, 2, 3), (0, 0, 0), 20.0, aspect, aperture=0.1, focus_dist=10.0)

    def check(label, packed, cam, mode, kw, plain_reps=0, kernel=mk.render_image_kernel,
              plain=mk.render_image_plain):
        """Kernel vs plain on the same inputs; with plain_reps, also times
        both (kernel: 5 calls). Returns (max_abs, ms, plain_ms, image, rays)."""
        if packed.mode != mode:
            fail(f"{label}: expected {mode} mode, got {packed.mode}")
        run = functools.partial(kernel, packed, cam, **kw)
        run_plain = functools.partial(plain, packed, cam, **kw)
        if plain_reps:
            (img, rays), ms = timed(run, reps=5)
            (ref, ref_rays), plain_ms = timed(run_plain, reps=plain_reps)
            print(f"[chip_smoke] {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})",
                  flush=True)
        else:
            (img, rays), ms, plain_ms = run(), None, None
            torch.cuda.synchronize()
            ref, ref_rays = run_plain()
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

    # each sphere mode at the frame the main path gives it (bench: grid; render CLI: brute)
    w, h = bench.FULL[:2]
    stats, frames = {}, {}
    for mode, label, scene, cam, extra in (
        ("grid", "grid rtiow 1920x1080 spp2 b8 lens", rtiow, rtiow_cam(w / h),
         dict(spp=2, lens=True)),
        ("brute", "brute two_spheres 1920x1080 spp4 b8", two_spheres_scene(device=dev),
         diffuse_cam(w / h), dict(spp=4)),
    ):
        packed = mk.pack_scene(scene)
        max_abs, ms, plain_ms, _, rays = check(
            label, packed, cam, mode, dict(width=w, height=h, max_bounces=8, seed=0, **extra),
            plain_reps=1)
        stats[f"sphere_megakernel[{mode}]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        frames[f"sphere_megakernel[{mode}]"] = (
            sphere_ops(packed.n_brute, rays, w, h, extra["spp"]),
            nbytes(packed.spheres) + (0 if packed.grid is None else nbytes(packed.grid.cell_ids)),
            w, h, "",
        )

    # the tape kernel
    tape_check = functools.partial(check, kernel=tk.render_image_tape_kernel,
                                   plain=tk.render_image_tape_plain)
    c3 = tk.pack_program(config3_csg_scene().compile(device=dev))
    tape_check("tape config3 512x512 spp16 b6", c3, cam_at((3, 2.5, 4), (0.1, 0, 0), 35.0, 1.0),
               "global", dict(width=512, height=512, spp=16, max_bounces=6, seed=3))

    graph5, animate5 = animated_csg_scene(8)
    tape5 = animate5(graph5.compile(k=4, device=dev), 1.0)
    w5, h5, _, b5 = bench.FRAMES["deepcsg"][0]
    cam5 = cam_at((0, 2.0, 7.0), (0.5, 0, 0), 40.0, w5 / h5)
    kw5 = dict(width=w5, height=h5, spp=2, max_bounces=b5, seed=0)
    tape_images = {}
    for mode, partition in (("clustered", "auto"), ("global", False)):
        packed = tk.pack_program(tape5, partition)
        max_abs, ms, plain_ms, img, rays = tape_check(
            f"tape config5 {mode} {w5}x{h5} spp2 b{b5}", packed, cam5, mode, kw5, plain_reps=1)
        tape_images[mode] = (img, rays)
        stats[f"tape_kernel[{mode}]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        frames[f"tape_kernel[{mode}]"] = (
            tape_ops(packed, rays, w5, h5, kw5["spp"]),
            nbytes(packed.leaf_table, packed.leaf_types, packed.ops, packed.cluster_table,
                   packed.leaf_ids),
            w5, h5, "",
        )
        if mode == "clustered":
            mhz = sm_clock_under_load(functools.partial(tk.render_image_tape_kernel, packed, cam5,
                                                        **kw5), ms)
            print(f"[chip_smoke] SM clock under load: {mhz:.0f} MHz ({card})", flush=True)
    compare("tape config5 kernel clustered vs kernel global", *tape_images["global"],
            *tape_images["clustered"])

    tape99 = many_objects_scene(99).compile(k=4, device=dev)
    cam99 = cam_at((0, 7.0, 9.0), (0, 0.4, 0), 45.0, 640 / 360)
    kw99 = dict(width=640, height=360, spp=2, max_bounces=8, seed=1)
    _, _, _, img99, rays99 = tape_check("tape many_objects(99) 640x360 spp2 b8",
                                        tk.pack_program(tape99), cam99, "clustered", kw99)
    ms99 = {}
    for mode, partition in (("clustered", "auto"), ("global", False)):
        (img, rays), ms99[mode] = timed(functools.partial(
            tk.render_image_tape_kernel, tk.pack_program(tape99, partition), cam99, **kw99), reps=3)
    compare("tape many_objects(99) kernel global vs kernel clustered", img99, rays99, img, rays)
    print(f"[chip_smoke] tape many_objects(99) 640x360 spp2 b8: kernel clustered "
          f"{ms99['clustered']:.3f} ms, global {ms99['global']:.3f} ms "
          f"({ms99['global'] / ms99['clustered']:.1f}x; {card})", flush=True)

    # the render CLI's manyobjects tape and camera at the main path's frame
    tape_check("tape CLI manyobjects 1920x1080 spp2 b8",
               tk.pack_program(many_objects_scene().compile(device=dev)),
               cam_at((9.0, 7.5, 12.0), (0.0, 0.3, 0.0), 42.0, w / h), "clustered",
               dict(width=w, height=h, spp=2, max_bounces=8, seed=0))

    g = SceneGraph()
    rot = tuple(float(x) for x in quat.from_axis_angle([0.0, 1.0, 0.0], 0.6))
    box = g.add_box_node((0.7, 0.7, 0.7), Material.metal((0.9, 0.8, 0.6), 0.05))
    cyl = g.add_cylinder_node(0.5, 1.2, Material.dielectric(1.5))
    half = g.add_infinite_planar_partition_node((0.0, 1.0, 0.0), Material.lambertian((0.4, 0.5, 0.6)))
    u = g.add_union_of_node(NodeArgument(box, orientation=rot), NodeArgument(cyl))
    g.add_union_of_node(NodeArgument(u), NodeArgument(half, offset=(0, -1.2, 0)))
    tape_check("tape rotated box, glass, half-space 256x256 spp4 b6",
               tk.pack_program(g.compile(k=2, device=dev), partition=False),
               cam_at((3, 2, 4), (0, 0, 0), 40.0, 1.0), "global",
               dict(width=256, height=256, spp=4, max_bounces=6, seed=7))
    g = SceneGraph(max_node_count=16)
    s = g.add_sphere_node(1.0, Material.normal_map())
    b = g.add_box_node((0.8, 0.8, 0.8), Material.normal_map())
    c = g.add_cylinder_node(0.55, 1.6, Material.normal_map())
    u = g.add_union_of_node(NodeArgument(s, offset=(-0.3, 0, 0)), NodeArgument(b, offset=(0.5, 0, 0)))
    g.add_difference_of_node(NodeArgument(u), NodeArgument(c))
    tape_check("tape normal-map attribution 256x256 spp1 b1", tk.pack_program(g.compile(k=2, device=dev)),
               cam_at((3, 2.5, 4), (0.1, 0, 0), 35.0, 1.0), "global",
               dict(width=256, height=256, spp=1, max_bounces=1, seed=3))

    # --- the NEE variants: night scenes at the night benchmarks' frame, 2 spp
    wn, hn, _, bn = bench.FRAMES["night"][0]
    kwn = dict(width=wn, height=hn, spp=2, max_bounces=bn, seed=0, sky="black", nee=True)

    def plain_counts(plain, packed, cam):
        """The NEE work of the plain version's run of the frame, as ints."""
        counts = {}
        plain(packed, cam, counts=counts, **kwn)
        return {k: int(v) for k, v in counts.items()}

    night_cam = cam_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), 32.0, wn / hn)
    night_runs = {}
    for mode, label, scene in (("brute", "night", night_scene(device=dev)),
                               ("grid", "night488", night_scene(grid=11, device=dev))):
        packed = mk.pack_scene(scene)
        max_abs, ms, plain_ms, img, rays = check(
            f"{mode}-nee {label} {wn}x{hn} spp2 b{bn}", packed, night_cam, mode, kwn, plain_reps=1)
        night_runs[label] = (scene, mode, ms, img, rays)
        name = f"sphere_megakernel[{mode}-nee]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        c = plain_counts(mk.render_image_plain, packed, night_cam)
        n_brute = packed.n_brute
        frames[name] = (
            sphere_ops(n_brute, rays, wn, hn, 2, "black") + nee_ops(
                c, OPS["ray"] + 1, n_brute * OPS["sphere_test"], OPS["sphere_test"],
                OPS["partner"]),
            nbytes(packed.spheres, packed.lamps)
            + (0 if packed.grid is None else nbytes(packed.grid.cell_ids)),
            wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
        )
    # each night scene in the other sphere mode: brute-nee vs grid-nee on one scene
    for label, (scene, mode, ms, img_auto, rays_auto) in night_runs.items():
        other = "grid" if mode == "brute" else "brute"
        forced = mk.pack_scene(scene, other == "grid")
        (img, rays), ms_other = timed(functools.partial(
            mk.render_image_kernel, forced, night_cam, **kwn), reps=3)
        compare(f"{label} {wn}x{hn} kernel {other}-nee vs kernel {mode}-nee", img_auto, rays_auto,
                img, rays)
        brute_ms, grid_ms = (ms, ms_other) if mode == "brute" else (ms_other, ms)
        print(f"[chip_smoke] {label} {wn}x{hn} spp2 b{bn}: kernel brute-nee {brute_ms:.3f} ms, "
              f"grid-nee {grid_ms:.3f} ms ({brute_ms / grid_ms:.2f}x; {card})", flush=True)

    csg_cam = cam_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), 38.0, wn / hn)
    night_tape = csg_night_scene().compile(k=4, device=dev)
    packed = tk.pack_program(night_tape)
    max_abs, ms, plain_ms, img_c, rays_c = tape_check(
        f"tape csgnight clustered-nee {wn}x{hn} spp2 b{bn}", packed, csg_cam, "clustered", kwn,
        plain_reps=1)
    stats["tape_kernel[clustered-nee]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    c = plain_counts(tk.render_image_tape_plain, packed, csg_cam)
    n_lamps = packed.lamp_ids.numel()
    frames["tape_kernel[clustered-nee]"] = (
        tape_ops(packed, rays_c, wn, hn, 2, "black") + nee_ops(
            c, 1, leaf_interval_ops(packed, range(packed.tape.n_leaves))
            + 2 * packed.tape.n_leaves * OPS["candidate_test"],
            leaf_interval_ops(packed, packed.clusters[0][1]),
            OPS["partner"] + n_lamps * OPS["lamp_match"]),
        nbytes(packed.leaf_table, packed.leaf_types, packed.ops, packed.cluster_table,
               packed.leaf_ids, packed.lamp_ids),
        wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
    )
    packed_g = tk.pack_program(night_tape, False)
    max_abs, ms_g, plain_ms, img_g, rays_g = tape_check(
        f"tape csgnight global-nee {wn}x{hn} spp2 b{bn}", packed_g, csg_cam, "global", kwn,
        plain_reps=1)
    stats["tape_kernel[global-nee]"] = dict(max_abs_err=max_abs, ms=ms_g, plain_ms=plain_ms)
    c = plain_counts(tk.render_image_tape_plain, packed_g, csg_cam)
    all_leaves = range(packed_g.tape.n_leaves)
    frames["tape_kernel[global-nee]"] = (
        tape_ops(packed_g, rays_g, wn, hn, 2, "black") + nee_ops(
            c, 1, leaf_interval_ops(packed_g, all_leaves)
            + 2 * packed_g.tape.n_leaves * OPS["candidate_test"],
            leaf_interval_ops(packed_g, packed_g.clusters[0][1]),
            OPS["partner"] + n_lamps * OPS["lamp_match"]),
        nbytes(packed_g.leaf_table, packed_g.leaf_types, packed_g.ops, packed_g.cluster_table,
               packed_g.leaf_ids, packed_g.lamp_ids),
        wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
    )
    compare(f"tape csgnight {wn}x{hn} kernel global-nee vs kernel clustered-nee", img_c, rays_c,
            img_g, rays_g)
    print(f"[chip_smoke] tape csgnight {wn}x{hn} spp2 b{bn}: kernel clustered-nee {ms:.3f} ms, "
          f"global-nee {ms_g:.3f} ms ({card})", flush=True)

    # the blocker scene of tests/test_nee.py: a sphere between the lamp and
    # the floor must cast its umbra through the grid-nee shadow rays
    rng = np.random.default_rng(11)

    def blocker_scene(radius):
        centers = [[0.0, -1000.0, 0.0], [0.0, 4.0, 0.0], [0.0, 2.0, 0.0]]
        radii, kinds = [1000.0, 0.5, radius], [1, 4, 1]
        albs, prms = [[0.7, 0.7, 0.7], [20.0, 20.0, 20.0], [0.1, 0.1, 0.1]], [0.0, 0.0, 0.0]
        for k in range(60):  # a filler ring far from the shadow axis, so the scene grids
            ang = 2 * np.pi * k / 60
            centers.append([6.0 * np.cos(ang), 0.2, 6.0 * np.sin(ang)])
            radii.append(0.2)
            kinds.append(1)
            albs.append(rng.random(3).tolist())
            prms.append(0.0)
        return sphere_scene_from_numpy(centers, radii, kinds, albs, prms, dev)

    blocker_cam = cam_at((0.0, 3.0, 6.0), (0.0, 0.0, 0.0), 40.0, 1.0)
    umbra = {}
    for name, radius in (("blocked", 0.8), ("open", 1e-4)):
        img = check(f"grid-nee blocker {name} 32x32 spp8 b3", mk.pack_scene(blocker_scene(radius), True),
                    blocker_cam, "grid", dict(width=32, height=32, spp=8, max_bounces=3, seed=4,
                                              sky="black", nee=True))[3]
        umbra[name] = float(img[12:20, 12:20].mean())
    print(f"[chip_smoke] blocker umbra {umbra['blocked']:.4f} vs open {umbra['open']:.4f} "
          f"(must be < 25%: {umbra['blocked'] / umbra['open']:.1%})", flush=True)
    if not umbra["blocked"] < 0.25 * umbra["open"]:
        fail("the blocker casts no umbra through the grid-nee shadow rays")

    # --- the triangle-mesh kernel: the four modes at the frames the kernel line reports
    mesh_check = functools.partial(check, kernel=tm.render_image_mesh_kernel,
                                   plain=tm.render_image_mesh_plain)

    def mesh_cam(eye, fw, fh, at=(0.0, 0.7, -2.6), vfov=45.0):
        return cam_at(eye, at, vfov, fw / fh)

    def walk_counts(packed, cam, kw):
        """The plain walk's work over the frame's path segments (NEE adds
        shadow rays, never segments, so a run without it has the same)."""
        counts = {}
        tm.render_image_mesh_plain(packed, cam, counts=counts,
                                   **{k: v for k, v in kw.items() if k != "nee"})
        return {k: int(v) for k, v in counts.items()}

    demo_eye = (0.0, 1.6, 2.2)  # tools/bench_mesh.py's camera
    floor = quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2),
                 Material.lambertian((0.55, 0.55, 0.5)), dev)
    ball = icosphere((0.0, 0.45, -1.9), 0.45, Material.lambertian((0.2, 0.35, 0.7)), 1, dev)
    mesh82 = concat_meshes(ball, floor)  # under pack_tri_grid's 192 faces: brute
    mesh_check("mesh brute 82 faces 256x144 spp4 b6", tm.pack_mesh(mesh82),
               mesh_cam(demo_eye, 256, 144), "brute",
               dict(width=256, height=144, spp=4, max_bounces=6, seed=1))
    wm, hm = 1280, 720
    kwm = dict(width=wm, height=hm, spp=2, max_bounces=6, seed=0)
    cam_m = mesh_cam(demo_eye, wm, hm)
    demo2 = mesh_demo_scene(2, device=dev)
    for mode, label, packed in (
        ("brute", "mesh_demo_scene(2) forced brute", tm.pack_mesh(demo2, False)),
        ("grid", "mesh_demo_scene(4)", tm.pack_mesh(mesh_demo_scene(4, device=dev))),
    ):
        max_abs, ms, plain_ms, img, rays = mesh_check(
            f"mesh {mode} {label} {wm}x{hm} spp2 b6", packed, cam_m, mode, kwm, plain_reps=1)
        name = f"trimesh_kernel[{mode}]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        walk = walk_counts(packed, cam_m, kwm) if mode == "grid" else None
        frames[name] = (
            mesh_ops(packed, rays, wm, hm, 2, walk=walk),
            nbytes(packed.faces) + (0 if packed.grid is None else nbytes(
                packed.grid.offsets, packed.grid.face_ids, packed.grid.globals_idx)),
            wm, hm, "" if walk is None else f"; walk {walk}",
        )
        if mode == "brute":
            img_b, rays_b = img, rays
    (img, rays), ms_g2 = timed(functools.partial(tm.render_image_mesh_kernel, tm.pack_mesh(demo2),
                                                 cam_m, **kwm), reps=3)
    compare(f"mesh_demo_scene(2) {wm}x{hm} kernel grid vs kernel forced brute", img_b, rays_b,
            img, rays)
    print(f"[chip_smoke] mesh_demo_scene(2) {wm}x{hm} spp2 b6: kernel brute "
          f"{stats['trimesh_kernel[brute]']['ms']:.3f} ms, grid {ms_g2:.3f} ms ({card})",
          flush=True)

    kwmn = dict(width=wn, height=hn, spp=2, max_bounces=bn, seed=0, sky="black", nee=True)
    lamp82 = concat_meshes(  # tests/test_nee.py's brute-path mesh NEE scene, two lamp faces
        icosphere((0, 0.7, -3), 0.7, Material.lambertian((0.6, 0.3, 0.3)), 1, dev),
        quad((-0.6, 2.2, -3.4), (0.6, 2.2, -3.4), (0.6, 2.2, -2.4), (-0.6, 2.2, -2.4),
             Material.emissive((12.0, 10.0, 8.0)), dev))
    for mode, label, packed, cam in (
        ("brute", "test_nee lamp scene", tm.pack_mesh(lamp82),
         mesh_cam((0, 1.4, 1.6), wn, hn, at=(0, 0.6, -3), vfov=50.0)),
        ("grid", "mesh_night_scene()", tm.pack_mesh(mesh_night_scene(device=dev)),
         mesh_cam((0, 1.8, 2.4), wn, hn)),
    ):
        max_abs, ms, plain_ms, img, rays = mesh_check(
            f"mesh {mode}-nee {label} {wn}x{hn} spp2 b{bn}", packed, cam, mode, kwmn, plain_reps=1)
        name = f"trimesh_kernel[{mode}-nee]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        counts = {}
        tm.render_image_mesh_plain(packed, cam, counts=counts, **kwmn)
        c = {k: int(counts[k]) for k in ("nee_vertices", "shadow_rays", "shadow_clear",
                                         "mis_emission", "carried_pdfs")}
        walk = walk_counts(packed, cam, kwmn) if mode == "grid" else None
        n_lamps = packed.lamps.shape[0]
        if mode == "brute":  # a clear shadow ray tests every face, an occluded one at least one
            clear = packed.mesh.num_faces * OPS["mt_test"]
        else:  # the globals and the walk's set-up (its voxels are left out: a floor)
            clear = packed.grid.n_globals * OPS["mt_test"] + OPS["walk_setup"]
        frames[name] = (
            mesh_ops(packed, rays, wn, hn, 2, "black", walk) + nee_ops(
                c, 1 + OPS["tri_weight"], clear, OPS["mt_test"],
                OPS["tri_partner"] + n_lamps * OPS["tri_lamp_match"], OPS["tri_sample"]),
            nbytes(packed.faces, packed.lamps) + (0 if packed.grid is None else nbytes(
                packed.grid.offsets, packed.grid.face_ids, packed.grid.globals_idx)),
            wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach a lamp)"
            + ("" if walk is None else f"; walk {walk}"),
        )
    # the 80-lamp scene of tests/test_nee.py (an emissive icosphere) in grid-nee
    lamps80 = concat_meshes(
        icosphere((-0.9, 0.7, -3.0), 0.7, Material.lambertian((0.6, 0.3, 0.3)), 2, dev),
        icosphere((0.2, 2.2, -2.6), 0.35, Material.emissive((14.0, 12.0, 9.0)), 1, dev),
        quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), Material.lambertian((0.5, 0.5, 0.5)),
             dev))
    packed80 = tm.pack_mesh(lamps80)
    if packed80.lamps.shape[0] != 80:
        fail(f"the 80-lamp scene has {packed80.lamps.shape[0]} lamps")
    mesh_check("mesh grid-nee 80 lamps 320x180 spp2 b3", packed80,
               mesh_cam((0, 1.6, 2.2), 320, 180), "grid",
               dict(width=320, height=180, spp=2, max_bounces=3, seed=7, sky="black", nee=True))

    # degenerate faces (two points and a segment) in view and inside the
    # grid's bounds, in both modes: never hit, so the image is the mesh's own
    v0 = np.array([[0.0, 0.6, -2.0], [-0.2, 0.5, -2.2], [0.1, 0.3, -2.5]], np.float32)
    e1 = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, 0.0], [0.0, 0.0, 0.0]], np.float32)
    degenerate = mesh_from_numpy(v0, e1, 2 * e1, np.ones(3, np.int32),
                                 np.full((3, 3), 0.5, np.float32), np.zeros(3, np.float32), dev)
    for mode, base in (("brute", mesh82), ("grid", demo2)):
        kwd = dict(width=256, height=144, spp=2, max_bounces=4, seed=2)
        cam_d = mesh_cam(demo_eye, 256, 144)
        packed = tm.pack_mesh(concat_meshes(base, degenerate), mode == "grid")
        img = mesh_check(f"mesh {mode} with degenerate faces 256x144 spp2 b4", packed, cam_d, mode,
                         kwd)[3]
        clean, _ = tm.render_image_mesh_kernel(tm.pack_mesh(base, mode == "grid"), cam_d, **kwd)
        if not torch.equal(img, clean):
            fail(f"degenerate faces changed the {mode} kernel's image")
    print("[chip_smoke] degenerate faces: never hit in brute or grid mode", flush=True)

    # the face-count ladder of tools/bench_mesh.py: mesh_demo_scene at subdiv 2-6
    ladder = []
    for sub, spheres in ((2, 3), (3, 3), (4, 3), (5, 3), (5, 5), (6, 3)):
        mesh = mesh_demo_scene(sub, spheres, device=dev)
        t0 = time.perf_counter()
        packed = tm.pack_mesh(mesh)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        if packed.mode != "grid":
            fail(f"ladder {mesh.num_faces} faces: expected grid mode, got {packed.mode}")
        mean_occ, max_occ, nonempty = packed.grid.occupancy()
        (_, rays), ms = timed(functools.partial(
            tm.render_image_mesh_kernel, packed, cam_m, width=wm, height=hm, spp=16,
            max_bounces=6, seed=0), reps=3)
        row = dict(faces=mesh.num_faces, dims=packed.grid.static.dims,
                   globals=packed.grid.n_globals, nonempty=nonempty, mean_list=mean_occ, max_list=max_occ, pack_s=pack_s,
                   grid_pack_s=packed.grid.pack_seconds, ms=ms, mrays_s=int(rays) / ms / 1e3)
        ladder.append(row)
        print(f"[chip_smoke] ladder {json.dumps(row)} ({wm}x{hm} spp16 b6; {card})", flush=True)
    mesh_check(f"mesh grid {ladder[-1]['faces']} faces 160x90 spp1 b6", packed,
               mesh_cam(demo_eye, 160, 90), "grid", dict(width=160, height=90, spp=1, max_bounces=6,
                                                         seed=0))

    if mk.LAUNCHES <= mk_launches0 or tk.LAUNCHES <= tk_launches0 or tm.LAUNCHES <= tm_launches0:
        fail("LAUNCHES did not increase in phase 2")
    phase2 = {f"tape_kernel[{m}]": tk.LAUNCHES_BY_MODE[m] - tk_phase2[m]
              for m in ("global", "global-nee")}
    phase2.update({f"trimesh_kernel[{m}]": tm.LAUNCHES_BY_MODE[m] - tm_phase2[m]
                   for m in ("brute", "brute-nee")})
    if not all(phase2.values()):
        fail(f"kernel modes never launched in phase 2: {phase2}")
    print(f"[chip_smoke] phase 2 ok: {mk.LAUNCHES - mk_launches0} sphere, "
          f"{tk.LAUNCHES - tk_launches0} tape and {tm.LAUNCHES - tm_launches0} mesh kernel "
          f"launches ({phase2})", flush=True)

    # --- phase 3: the main paths (benchmarks + render CLI), counts from zero
    os.makedirs(OUT_DIR, exist_ok=True)
    for mod in (mk, tk, tm):
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0
    t0 = time.perf_counter()
    result, img = bench.run_bench(quick=False, frames=3, device="cuda")
    result5, img5 = bench.run_bench(scene="deepcsg", quick=False, frames=3, device="cuda")
    nee_benches = {scene: bench.run_bench(scene=scene, quick=False, frames=3, device="cuda")
                   for scene in ("night", "night488", "csgnight", "mesh", "meshnight")}
    pngs = {}
    for scene, (fw, fh) in (("diffuse", (1920, 1080)), ("csg", (1920, 1080)),
                            ("manyobjects", (1920, 1080)), ("csgnight", (wn, hn)),
                            ("meshnight", (wn, hn))):
        pngs[scene] = os.path.join(OUT_DIR, f"{scene}_{fh}p.png")
        cli_main(["render", "--scene", scene, "--width", str(fw), "--height", str(fh),
                  "--spp", "16", "--device", "cuda", "--out", pngs[scene]])
    torch.cuda.synchronize()
    counts = {f"sphere_megakernel[{m}]": n for m, n in mk.LAUNCHES_BY_MODE.items()}
    counts.update({f"tape_kernel[{m}]": n for m, n in tk.LAUNCHES_BY_MODE.items()})
    counts.update({f"trimesh_kernel[{m}]": n for m, n in tm.LAUNCHES_BY_MODE.items()})
    print(f"[chip_smoke] main path took {time.perf_counter() - t0:.1f} s; launches {counts}",
          flush=True)
    benches = {"rtiow": (result, img), "deepcsg": (result5, img5), **nee_benches}
    for name, (res, image) in benches.items():
        print(json.dumps(res), flush=True)
        fw, fh, fspp, _ = bench.FRAMES[name][0]
        if tuple(image.shape) != (fh, fw, 3) or not bool(torch.isfinite(image).all()):
            fail(f"{name} bench image has shape {tuple(image.shape)} or non-finite pixels")
        if res["rays"] // res["frames"] < fw * fh * fspp:
            fail(f"{name} bench traced fewer rays per frame than one per sample")
        if not float(image.max()) > 0.0:
            fail(f"{name} bench image is black")
    missing = [p for p in pngs.values() if not os.path.isfile(p)]
    if missing:
        fail(f"render CLI wrote no PNG: {missing}")
    idle = [k for k in ("sphere_megakernel[grid]", "sphere_megakernel[brute]",
                        "sphere_megakernel[grid-nee]", "sphere_megakernel[brute-nee]",
                        "tape_kernel[clustered]", "tape_kernel[clustered-nee]",
                        "trimesh_kernel[grid]", "trimesh_kernel[grid-nee]") if counts[k] == 0]
    if idle:
        fail(f"kernel modes never launched on the main path: {idle}")

    kernels = []
    for name in ("sphere_megakernel[grid]", "sphere_megakernel[brute]",
                 "sphere_megakernel[grid-nee]", "sphere_megakernel[brute-nee]",
                 "tape_kernel[clustered]", "tape_kernel[global]", "tape_kernel[clustered-nee]",
                 "tape_kernel[global-nee]", "trimesh_kernel[brute]", "trimesh_kernel[grid]",
                 "trimesh_kernel[brute-nee]", "trimesh_kernel[grid-nee]"):
        base = name.split("[")[0]
        source, replaces = KERNELS[base]
        ops, table_bytes, fw, fh, note = frames[name]
        bound_ms, bound_by, _, total_bytes = bound(ops, table_bytes, fw, fh, mhz)
        print(f"[chip_smoke] {name} frame {fw}x{fh}: {ops} FP32 ops, {total_bytes} bytes -> bound "
              f"{bound_ms:.3f} ms ({bound_by}; {SMS}x{LANES} lanes at {mhz:.0f} MHz, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s){note}", flush=True)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=counts[name], **stats[name], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None))
    # the benchmark frames' bounds, beside their median kernel-frame time
    for name, res, packed_ops in (
        ("rtiow", result, lambda r, fw, fh, fspp: sphere_ops(
            mk.pack_scene(rtiow).n_brute, r, fw, fh, fspp)),
        ("deepcsg", result5, lambda r, fw, fh, fspp: tape_ops(
            tk.pack_program(tape5), r, fw, fh, fspp)),
    ):
        fw, fh, fspp, _ = bench.FRAMES[name][0]
        per_frame = res["rays"] // res["frames"]
        ms_bound, by, ops, _ = bound(packed_ops(per_frame, fw, fh, fspp), 0, fw, fh, mhz)
        frame_ms = sorted(res["frame_times_s"])[len(res["frame_times_s"]) // 2] * 1e3
        print(f"[chip_smoke] bench {name} frame {fw}x{fh} spp{fspp}: {per_frame} segments, "
              f"{ops} FP32 ops, bound {ms_bound:.3f} ms ({by}), median frame {frame_ms:.3f} ms "
              f"({card})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
