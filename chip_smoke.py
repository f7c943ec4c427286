"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first that fails ends the run with a non-zero exit):

1. Environment: torch/CUDA/nvcc versions, the card and its power limit;
   build every CUDA kernel from csgrenderer_tpu_torch/kernels/csrc (one
   nvcc each, started together) and print ptxas' registers and spills.
2. Each kernel against its plain torch version on the card. The sphere
   kernel in brute mode (two spheres; the small RTIOW scene) and grid mode
   (the RTIOW final scene at 320x180, 4 spp, 8 bounces), grid against
   forced brute, then each mode at the frame the main path gives it
   (1920x1080: grid on the RTIOW final scene, brute on the two-sphere
   scene), each printed with where its launches read the scene tables
   (staged in shared memory, or global memory: the launcher's choice by
   size); and the grid frame with its tables staged and with them forced
   to global memory, timed, the two images equal bit for bit. The tape kernel on config3 (BASELINE's 512x512, 16 spp, 6
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
   sphere mode and its kernel image compared; the kernel's shadow-ray
   count printed beside the plain version's and held to it as the segments
   are), csg_night_scene() in
   clustered-nee mode and in global-nee mode (the two kernel images
   compared); and the blocker scene of tests/test_nee.py in grid-nee mode,
   whose umbra must be darker than a quarter of the open case. The mesh
   kernel: brute mode on an 82-face mesh (a subdiv-1 icosphere and
   mesh_demo_scene's floor) at 256x144, 4 spp, and on mesh_demo_scene(2)
   forced brute at 1280x720, 2 spp, 6 bounces (its image also against the
   grid kernel's); grid mode on mesh_demo_scene(4) at the same frame;
   brute-nee on tests/test_nee.py's 82-face lamp scene and grid-nee on
   mesh_night_scene() at 960x540, 2 spp, 6 bounces, each printed with where
   its launches read the tables (the tape kernel stages them always, the
   mesh kernel when they fit); the meshnight frame with its tables staged
   and with them forced to global memory, timed, the two images equal bit
   for bit; config 7's launch of tools/validate_gpu.py (mesh_night_scene(),
   96x54, 1,024 spp at sample offset 6,144) three times on the grid-nee
   build as shipped, in a child process under a time limit
   (``tools/shadow_walk_probe.config7_counts``, ROADMAP C-7), each tracing
   9,416,222 segments; grid-nee on the 80-lamp scene of tests/test_nee.py; degenerate faces in both modes
   (never hit); and the face-count ladder of tools/bench_mesh.py (962 to
   245,762 faces), each rung packed (times printed) and kernel-timed at
   1280x720, 16 spp, 6 bounces, the last also against the plain walk at
   160x90, 1 spp. The tape kernel's interval-list audit mode
   (``with_overflow=True``): the three pearls of
   tests/test_interval_overflow.py at k = 2, 256x256, at 1 spp and 1
   bounce (the dropped-span count ``over`` exactly equal to the plain
   version's) and at 2 spp and 3 bounces (``over`` within the rays' bound:
   a silhouette flip changes which segments exist); config5 at 1920x1080,
   2 spp, 5 bounces, k = 4 against its plain version; audit-nee on
   csgnight at 320x180 and at 960x540, 2 spp, 6 bounces. Kernel and plain
   version are timed with CUDA events at the frames the kernel line
   reports. Bounds
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
   at 960x540, 16 spp (the render CLI goes through the app layer's
   renderers); the audit of config5 at 1920x1080, 2 spp, 5 bounces, k = 4
   (``over`` must be 0 and the image equal to the event-flip kernel's,
   else within the compare bounds with the differing share printed) and
   of csgnight at 960x540 with NEE; tools/make_goldens.py's configs 1-5
   and 7 through ``PathTraceRenderer(device="cuda")`` /
   ``WololoRenderer``, each held against the same renderer on the CPU (the
   plain versions) and printed with its RMSE to the golden; ``gif --scene
   deepcsg --frames 4`` (one tape launch per frame, the tape reclustered
   on a CPU copy each frame); and the realtime loop, ``App.run`` with two
   frames in flight over ``PathTraceRenderer(rtiow_final_scene(),
   advance_samples=True)`` at 1280x720, 2 spp, with its frames per
   second over three runs of each setting, the host's time to enqueue
   a frame and one traced frame's device operations and busy time. The
   sphere kernel's grid, brute, grid-nee and brute-nee modes, the tape
   kernel's clustered, clustered-nee, audit and audit-nee
   modes and the mesh kernel's grid and grid-nee modes must have launched
   in this phase, a sphere launch with its tables in shared memory and mesh
   launches with theirs in shared memory (meshnight) and in global memory
   (the bench mesh); the tape kernel's global and global-nee modes and the
   mesh kernel's brute and brute-nee modes must have launched in phase 2.
   Phase 2 also holds the row slabs (``rows=``, ``row_offset=``) of each
   kernel at its main-path frame to the full frame's rows, bit for bit.
4. The tools path, counts from zero: ``python -m
   csgrenderer_tpu_torch.tools.exp_gather``, ``exp_slab`` and
   ``exp_dot_k`` (kernel rows 6-8, ``csgrenderer_tpu_torch/tools/
   exp_*.py``). Each tool's main() holds every run it makes (each mode;
   each combo and mode of exp_dot_k, so every kernel shape) at n_iter =
   2,000 to its plain version and the float64 formula (within 1e-6 x
   sum|terms|) and the paired modes to the bit (onehot = shuffle, lane =
   sublane, loopscalar = carryscalar), raising on a miss; it times each
   run and its plain version there and the run's slope over n_iter =
   2,000 and 42,000 (CUDA events). Then ``tools.validate_gpu --only config1,config2`` (the
   milestone-01 frame against its golden; config2's noise certificate and
   same-seed RMSE of the sphere kernel against the plain path), which must
   pass. Every experiment mode and the sphere kernel's brute mode must
   have launched in this phase.
5. The parallel path (``csgrenderer_tpu_torch/parallel``), counts from
   zero. One process: ``render_scene_sharded`` over
   ``single_device_mesh()`` on the RTIOW final scene (sphere grid) and the
   two-sphere scene (brute) at 1920x1080, config5 (tape, clustered) at
   1920x1080, mesh_demo_scene(4) (mesh grid) at 1280x720, night_scene()
   (brute-nee) and mesh_night_scene() (grid-nee) at 960x540, each at 2 spp,
   equal to the unsharded kernel frame bit for bit with the rays equal.
   Two ranks on the one card (``parallel.launch.run_ranks``: spawned
   interpreters joined by ``initialize_multihost`` over gloo on
   127.0.0.1; the kernels were built in phase 1, so no rank compiles):
   the same six frames at meshes 2x1 and 1x2, gathered on rank 0 and held
   to the one-process frames (2x1 bit for bit, 1x2 within atol 1e-5; rays
   equal); the RTIOW bench frame (1920x1080, 64 spp, 8 bounces, lens) at
   2x1 over 3 timed frames, its Mrays/s printed beside phase 3's
   one-process bench; ``render_to_noise_sharded`` on the two-sphere scene
   at 96x54 (target 1e-2, 16-spp chunks) at 2x1 against
   ``PathTraceRenderer(device="cuda").render_to_noise`` (spp used and rays
   equal, noise within rel 1e-5, the image bit for bit; every rank holds
   the same noise). Four ranks, mesh 2x2: the shard canary (kernel row 9)
   in every rank on an input that varies with the tile index, equal to
   ``scale2_plain`` and ``torch.mul(x, 2.0)`` bit for bit; config5 within
   atol 1e-5 of the one-process frame. Each rank returns its launch
   counts: the sphere kernel's grid, brute and brute-nee, the tape
   kernel's clustered, the mesh kernel's grid and grid-nee modes and the
   canary must have launched in a rank. A rank that fails, or a world
   that has not finished in its time limit, fails the run. Then the
   canary is timed against its plain version and ``torch.mul`` (CUDA
   events over 1,000 calls, which at this size measure the launch rate;
   beside them each call's device time from torch.profiler), and each step
   of the wrapper's host path on its own (host clock over 20,000 calls:
   the device check, check_tensor, the allocation, the current-device
   compare, the stream lookup, a ctypes call without CUDA and the ctypes
   call that launches, beside the steps the launch path dropped); its bound
   is 8,192 bytes over 3.35 TB/s.
6. The realtime and denoise path. First, on the RTIOW final scene at
   1280x720 and 1920x1080 and on a ragged 997x563 frame, the sphere
   kernel's G-buffer mode (``megakernel.render_aovs_kernel``, kernel row
   11) against its plain version (``render_aovs`` through the packed
   grid's hit function): the share of pixels that differ (at most 0.2%)
   and the max abs error where both hit (<= 1e-5), and its share against
   the plain brute cast, each timed (CUDA events, 50 calls queued behind a
   device sleep) beside the plain version, with its bound (one segment a
   pixel, the walk counted, against 29 bytes a pixel written); then the
   a-trous kernel
   (``kernels/csrc/atrous.cu``, one launch a pass) against its plain
   version on the 2-spp lens frame and those AOVs, 4 passes (5 on the
   ragged frame, so the step reaches 16), bit for bit, each timed beside
   the eager plain filter. The G-buffer cast's table paths at 1280x720:
   on the RTIOW scene staged in shared memory and forced to global memory
   (``force_global=True``), bit for bit; on rtiow_final_scene(grid=40)
   (6,402 spheres, its tables over the shared-memory limit) from global
   memory by the launcher's choice, against its plain version (pixel
   share and max abs as above); each printed with the memory it read.
   Then, counts from zero: the denoised realtime
   frame (``PathTraceRenderer(rtiow_final_scene(), advance_samples=True)``
   at 1280x720, 2 spp, lens, ``denoise=True``): host enqueue and drained
   ms a frame over 50 frames beside phase 3's undenoised ones, with
   torch's sync debug mode raising on any host wait inside a frame, and
   at least one G-buffer launch a frame; the frame's split into the
   beauty kernel, the renderer's AOV cast (the G-buffer mode over its
   packed scene) and the 4 filter passes (CUDA events behind a device
   sleep, so each interval is device time) beside the eager plain filter;
   ``App.run`` over it. ``AdaptiveSppRenderer`` on night_scene() (NEE, 960x540,
   target 0.02) through ``App.run`` for 256 frames, two in flight: the
   spp rungs visited and frames per second; it fails if the ladder never
   leaves its first rung or a frame's samples overlap another's. The demo
   6 twin (``python -m csgrenderer_tpu_torch.demos.demo6_realtime --scene
   rtiow --denoise --serve 0 --seconds 3``) in a child process, one
   ``/frame`` fetched from its preview server while it runs; it fails on a
   non-zero exit or an empty frame. ``tools.validate_gpu --only config11``
   (rmse_den < 0.72 x rmse_raw and rmse_den <= 0.08), which must pass.
   The a-trous kernel, the sphere kernel's grid, brute-nee and gbuffer
   modes must have launched. The a-trous entry in the kernels line is a
   quarter of the whole 4-pass filter at 1280x720 (its bound from the
   operations the filter needs, ``atrous_bound``, not those the kernel
   does); the G-buffer entry is one cast at 1280x720.
7. The demos (``csgrenderer_tpu_torch/demos/demoN_*.py``), counts from
   zero, each through its ``main(argv)`` in this process with ``--device
   cuda``, at its JAX twin's default frame unless noted: demo 1 (the
   milestone-01 frame: torch ops, no kernel); demo 2 (800x450, 16 spp:
   sphere brute); demo 3 (512x512, 16 spp) from the Python graph and with
   ``--native`` (the C++ scene core; the two tapes compared field by field
   and the two images bit for bit, else within the compare bounds with the
   differing share printed; tape kernel); demo 4 (1920x1080, 64 spp, 8
   bounces, lens, 3 frames: sphere grid; its Mrays/s printed beside phase
   3's bench rtiow, the same scene and frame); demo 5 at 3840x2160, 2 spp,
   5 bounces: 4 frames with ``--checkpoint``, then ``--resume`` for 2 more,
   held bit for bit (the accumulator, the sample count and the traced
   rays) to 6 uninterrupted frames, then ``--orbit`` for 2 frames and
   ``--target-noise 1e-2`` at 512x512 (tape kernel); demo 7 (640x360, 32
   spp) as it is (mesh grid), ``--worklist off`` (mesh brute), ``--nee``
   (mesh grid-nee), ``--subdiv 4`` (15,362 faces) and ``--obj`` of
   mesh_demo_scene(1) written with ``io.obj.write_obj``; demos 8 and 9
   (960x540, 64 spp) with ``--nee`` (sphere brute-nee, tape clustered-nee)
   and ``--no-nee``. It fails on a non-zero exit, a missing or constant
   PNG, a kernel mode of a run that did not launch in it, demo 3's native
   image off the Python graph's, or demo 5's resumed accumulation off the
   uninterrupted one. The demos' files go to chiprun_out/chip_smoke/demos;
   those over 4 MB (the 4K frames, the checkpoints) are deleted at the end.

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
hit is counted as a miss, a tape candidate costs its first test only (the
others are short-circuited when it fails), and a tape segment walks the
ops of one cluster, the smallest, only if it surely hits (a candidate past
the best t, or outside (eps, cut), is skipped without a walk; a miss may
walk none). A sphere grid segment adds the walk's set-up and, from the
plain walk's counts of the same segments (``counts=``), the walks, cell
visits and sphere tests it executes. An audit segment runs the whole
tape's lists, whose widths are static (min(ka + kb, k) per combine): per
leaf its interval and clip, per combine the merge's comparisons until one
operand runs out, every midpoint and one slot test per slot and midpoint
(the second is short-circuited), per root slot two tests and a min; the
dropped-span count's tests are left out. A miss under the black sky adds
no sky. The NEE modes add, from the plain
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

A micro-experiment's bound (``exp_bound``) is that of one call at n_iter
= 2,000 for the function it computes, the same for every mode of that
function: its table, index and result bytes once, and FP32 adds: per
result entry and iteration, exp_gather's sum of the 115 rows of the
column it reads and the accumulation; per iteration, exp_slab's column
sum (248 adds) and exp_dot_k's sum of the k columns' rr_pad entries, each
with the accumulation (every result entry holds the same value); "vote"
adds its term per lane and iteration and the k vote passes over the page
row once (a compare, a select and two adds per entry). What a mode does
beyond that (the one-hot products, the tensor-core MMA) is its own cost,
shown by its time, not by the bound. A one-CTA dependent loop is bound by
one SM's latency, not by the card's rates, so these bounds are far below
the times by design.
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
    "exp_gather": (f"{CSRC}/exp_gather.cu", "tools/exp_gather.py:62"),
    "exp_slab": (f"{CSRC}/exp_slab.cu", "tools/exp_slab.py:73"),
    "exp_dot_k": (f"{CSRC}/exp_dot_k.cu", "tools/exp_dot_k.py:116"),
    "shard_canary": (f"{CSRC}/shard_canary.cu", "tests/test_parallel.py:160"),
    "atrous": (f"{CSRC}/atrous.cu", "no Pallas kernel: the XLA fusion of "
               "csgrenderer_tpu/render/denoise.py:37 (atrous_denoise)"),
}  # the NEE modes are the same pallas_call with lamps (n_lights > 0; nee_lamps)
GBUFFER_REPLACES = ("no Pallas kernel: the jnp AOV cast of csgrenderer_tpu/render/aov.py:41 "
                    "(render_aovs), which XLA fuses")
EXP_N_ITER = 2000  # the tools' default --n-iter: each run is checked, timed and bounded there
EXP_REPS = {"exp_gather": 1, "exp_slab": 3, "exp_dot_k": 1}  # timed calls per loop length
SMS, LANES = 132, 128
REALTIME_FRAMES = 200
REALTIME_REPEATS = 3  # runs of each frames-in-flight / readback setting
HBM_BYTES_PER_S = 3.35e12
GBUFFER_TOL = 1e-5  # max abs, G-buffer kernel against its plain version where both hit
DENOISE_FRAMES = 50  # timed frames of the denoised realtime frame
DENOISE_FRAME = (1280, 720)  # the realtime cell's frame
DENOISE_CHECKS = (DENOISE_FRAME, (1920, 1080))  # frames the a-trous kernel is held at
DENOISE_RAGGED = (997, 563)  # a frame no 16x16 block divides, at 5 passes (step 16)
GBUFFER_SHARE = 2e-3  # most pixels the G-buffer kernel may differ on from its plain version
GBUFFER_BYTES = 4 + 12 + 12 + 1  # written a pixel: depth, normal, albedo, hit
GBUFFER_BIG_GRID = 40  # rtiow_final_scene(grid=40): 6,402 spheres, tables over the smem limit
ADAPTIVE_FRAMES = 256  # App.run frames of the adaptive night run
ADAPTIVE_FRAME = (960, 540)  # the night benchmarks' frame
DEMO6_ARGS = ("--scene", "rtiow", "--denoise", "--serve", "0", "--seconds", "3")

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
    "walk_skip": 36,  # a coarse block left in one turn: its three far-face crossings, the
                      # least, the other axes' crossings before it, the exit tests
    "tri_sample": 48,  # lamp pick, area sample, direction, cosine-lobe pdf, |cos_l|, tests
    "tri_weight": 13,  # q and the MIS-weighted contribution of a traced sample
    "tri_partner": 26,  # the lamp's q from the previous vertex, q / (q + 1)
    "tri_lamp_match": 10,  # per lamp: |plane distance| and its test
    "grid_setup": 34,  # sphere grid walk: 1/d, three slab ranges, t_in, t_out, the march test
    "grid_start": 34,  # the first cell, steps, flat tests, tmax and td (a ray that enters)
    "grid_step": 5,  # one advance: the next crossing, its axis, the exit tests
    "list_push": 5,  # audit: the leaf interval's two clips and its validity test
    "merge_compare": 1,  # audit: one comparison of the two-pointer merge
    "midpoint": 2,  # audit: 0.5 (e_j + e_j+1); the last midpoint is one add
    "slot_inside": 1,  # audit: in <= m per slot and midpoint (m < out short-circuited)
    "root_slot": 4,  # audit: per root slot, t > eps and min, for the enter and the exit
    "list_hit": 2,  # audit: min of the first enter and exit, entering's test
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


def timed_queued(fn, reps, mhz):
    """(result of the last call, device ms per call) with CUDA events, the
    ``reps`` calls queued behind a 20 ms device sleep: the host enqueues
    them all before the device reaches the first, so a call whose host
    side outlasts its kernel is timed by its kernel, not by the host."""
    import torch

    out = fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(mhz * 2e4))
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


def sphere_ops(n_brute, rays, width, height, spp, sky="rtiow", walk=None):
    """A sphere frame's path-segment work: the brute pass over ``n_brute``
    spheres per segment and, in grid mode, the walk's set-up per segment
    and from ``walk`` (the plain walk's counts of the same segments) the
    walks, cell visits and sphere tests it executes."""
    hits = hits_floor(rays, width, height, spp)
    per_segment = OPS["ray"] + n_brute * OPS["sphere_test"] + OPS["segment"]
    ops = 0
    if walk is not None:
        per_segment += OPS["grid_setup"]
        ops = (walk["walks"] * OPS["grid_start"] + walk["cell_visits"] * OPS["grid_step"]
               + walk["sphere_tests"] * OPS["sphere_test"])
    return (ops + int(rays) * per_segment + hits * OPS["sphere_hit"]
            + (int(rays) - hits) * miss_ops(sky))


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


def list_eval_ops(packed):
    """FP32 operations of one audit-mode evaluation of the whole tape."""
    types, k = packed.tape.leaf_types, packed.tape.k
    ops, widths = 0, []
    for opcode, arg in packed.tape.ops:
        if opcode == 0:  # PUSH
            ops += OPS["leaf_transform"] + OPS["interval"][types[arg]] + OPS["list_push"]
            widths.append(1)
            continue
        kb, ka = widths.pop(), widths.pop()
        n = 2 * (ka + kb) + 1
        ops += (min(2 * ka, 2 * kb) * OPS["merge_compare"] + (n - 1) * OPS["midpoint"] + 1
                + n * (ka + kb) * OPS["slot_inside"])
        widths.append(min(ka + kb, k))
    return ops + widths[0] * OPS["root_slot"] + OPS["list_hit"]


def audit_ops(packed, rays, width, height, spp, sky="rtiow"):
    types = packed.tape.leaf_types
    per_hit = OPS["tape_hit"] + sum(OPS["attribution"][t] for t in types)
    hits = hits_floor(rays, width, height, spp)
    return (int(rays) * (list_eval_ops(packed) + OPS["segment"]) + hits * per_hit
            + (int(rays) - hits) * miss_ops(sky))


def mesh_ops(packed, rays, width, height, spp, sky="rtiow", walk=None):
    """A mesh frame's path-segment work: in brute mode every face tested
    per segment; in grid mode the globals, the walk's set-up, and from
    ``walk`` (the plain walk's counts of the same segments) the walks,
    voxel visits, coarse skips and face tests it executes."""
    hits = hits_floor(rays, width, height, spp)
    per_segment = OPS["segment"]
    ops = 0
    if packed.grid is None:
        per_segment += packed.mesh.num_faces * OPS["mt_test"]
    else:
        per_segment += packed.grid.n_globals * OPS["mt_test"] + OPS["walk_setup"]
        ops = (walk["walks"] * OPS["walk_start"] + walk["voxel_visits"] * OPS["walk_step"]
               + walk.get("coarse_skips", 0) * OPS["walk_skip"]
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


def exp_bound(name, mode, mhz, table_bytes, rr_pad=0, k=0, n_iter=EXP_N_ITER):
    """(bound_ms, bound_by) of one micro-experiment call: the function's
    own work, the same for every mode that computes it (see the
    docstring's rule)."""
    io_bytes = table_bytes + 2 * 8 * 128 * 4  # + idx [8, 128] i32 and out [8, 128] f32
    if name == "exp_gather":
        ops = n_iter * 8 * 128 * (115 + 1)
    elif name == "exp_slab":
        ops = n_iter * (248 + 1)
    else:
        ops = n_iter * (rr_pad * k + 1) + (n_iter * 128 + k * 128 * 4 if mode == "vote" else 0)
    ops_ms = ops / (SMS * LANES * mhz * 1e6) * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


SHARD_CASES = {  # phase 5's scenes: name -> the kernel mode it drives
    "rtiow": "sphere_megakernel[grid]",
    "two_spheres": "sphere_megakernel[brute]",
    "config5": "tape_kernel[clustered]",
    "mesh_demo(4)": "trimesh_kernel[grid]",
    "night": "sphere_megakernel[brute-nee]",
    "meshnight": "trimesh_kernel[grid-nee]",
}
NOISE_FRAME = dict(width=96, height=54, spp=16, max_bounces=8, seed=0)  # render-to-noise, 1e-2
SHARD_BENCH = dict(spp=64, max_bounces=8, frames=3)  # the RTIOW bench frame at mesh 2x1


def shard_case(name, dev):
    """(scene, camera, frame) of phase 5's case ``name`` at 2 spp, on the
    frame the main path gives its kernel mode (phases 2 and 3)."""
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch import models

    def cam(eye, at, vfov, w, h, **kw):
        return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=w / h, device=dev, **kw)

    w, h = bench.FULL[:2]
    w5, h5, _, b5 = bench.FRAMES["deepcsg"][0]
    wn, hn, _, bn = bench.FRAMES["night"][0]
    night = dict(width=wn, height=hn, spp=2, max_bounces=bn, seed=0, sky="black", nee=True)
    if name == "rtiow":
        return (models.rtiow_final_scene(device=dev),
                cam((13, 2, 3), (0, 0, 0), 20.0, w, h, aperture=0.1, focus_dist=10.0),
                dict(width=w, height=h, spp=2, max_bounces=8, seed=0, lens=True))
    if name == "two_spheres":
        return (models.two_spheres_scene(device=dev), cam((0, 0, 0), (0, 0, -1), 90.0, w, h),
                dict(width=w, height=h, spp=2, max_bounces=8, seed=0))
    if name == "config5":
        graph, animate = models.animated_csg_scene(8)
        return (animate(graph.compile(k=4, device=dev), 1.0),
                cam((0, 2.0, 7.0), (0.5, 0, 0), 40.0, w5, h5),
                dict(width=w5, height=h5, spp=2, max_bounces=b5, seed=0))
    if name == "mesh_demo(4)":
        return (models.mesh_demo_scene(4, device=dev),
                cam((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), 45.0, 1280, 720),
                dict(width=1280, height=720, spp=2, max_bounces=6, seed=0))
    if name == "night":
        return models.night_scene(device=dev), cam((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), 32.0, wn, hn), night
    return (models.mesh_night_scene(device=dev), cam((0, 1.8, 2.4), (0.0, 0.7, -2.6), 45.0, wn, hn),
            night)


def launch_counts():
    """Every kernel mode's launch count in this process."""
    from csgrenderer_tpu_torch.kernels import megakernel, shard_canary, tape_kernel, trimesh_kernel

    return {f"{mod.KERNEL_SOURCE}[{m}]": n
            for mod in (megakernel, tape_kernel, trimesh_kernel, shard_canary)
            for m, n in mod.LAUNCHES_BY_MODE.items()}


def phase5_rank(ref_path, device="cuda"):
    """One rank of phase 5 (run by ``parallel.launch.run_ranks``). Two
    ranks: the six cases at meshes 2x1 and 1x2, gathered and held on rank 0
    to the one-process images in ``ref_path``; the RTIOW bench frame at 2x1
    (``SHARD_BENCH``); render-to-noise at 2x1. Four ranks:
    the shard canary in every rank, and config5 at 2x2. Returns what the
    parent checks and prints, with this rank's launch counts."""
    import torch
    import torch.distributed as dist

    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import shard_canary as sc
    from csgrenderer_tpu_torch.models import two_spheres_scene
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.parallel import (
        gather_rows,
        make_mesh,
        render_scene_sharded,
        render_to_noise_sharded,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    refs = torch.load(ref_path) if rank == 0 else None
    out = {"rank": rank, "checks": []}

    def render_and_hold(name, mesh, exact):
        scene, cam, frame = shard_case(name, mesh.device)
        img, rays = render_scene_sharded(scene, cam, mesh=mesh, **frame)
        full = gather_rows(img, mesh)
        if rank == 0:
            ref, ref_rays = refs[name]
            full = full.cpu()
            out["checks"].append(dict(
                mesh=f"{mesh.tile_ways}x{mesh.sample_ways}", name=name, exact=exact,
                frame=f"{frame['width']}x{frame['height']}", equal=torch.equal(full, ref),
                max_abs=float((full - ref).abs().max()), rays=int(rays), ref_rays=ref_rays))

    if world == 2:
        for t, s in ((2, 1), (1, 2)):
            mesh = make_mesh(t, s, device=device)
            for name in SHARD_CASES:
                render_and_hold(name, mesh, s == 1)
        # the RTIOW bench frame at full width, packed once as the bench packs it
        mesh = make_mesh(2, 1, device=device)
        scene, cam, frame = shard_case("rtiow", mesh.device)
        packed = mk.pack_scene(scene)
        times, rays_total = [], 0
        for i in range(SHARD_BENCH["frames"] + 1):  # the first is a warm-up
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, rays = render_scene_sharded(packed, cam, frame["width"], frame["height"], mesh,
                                           spp=SHARD_BENCH["spp"],
                                           max_bounces=SHARD_BENCH["max_bounces"], seed=0,
                                           lens=True, sample_offset=i)
            r = int(rays)  # the count's all-reduce waits for both ranks' kernels
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
                rays_total += r
        out["bench"] = dict(times=times, rays=rays_total,
                            frame=f"{frame['width']}x{frame['height']}")
        cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                             aspect_ratio=NOISE_FRAME["width"] / NOISE_FRAME["height"],
                             device=mesh.device)
        acc, noise, used = render_to_noise_sharded(
            two_spheres_scene(device=mesh.device), cam, NOISE_FRAME["width"],
            NOISE_FRAME["height"], mesh, target=1e-2, spp_chunk=NOISE_FRAME["spp"],
            max_bounces=NOISE_FRAME["max_bounces"], seed=NOISE_FRAME["seed"])
        image = gather_rows(acc.image(), mesh)
        out["noise"] = (noise, used, acc.rays_traced, image.cpu() if rank == 0 else None)
    else:
        mesh = make_mesh(2, 2, device=device)
        x = torch.ones(sc.SHAPE, dtype=torch.float32, device=mesh.device) + mesh.tile_index
        o = sc.scale2_kernel(x)
        out["canary"] = (torch.equal(o, sc.scale2_plain(x)), torch.equal(o, torch.mul(x, 2.0)),
                         float((o - sc.scale2_plain(x)).abs().max()))
        gathered = gather_rows(o[None], mesh)
        if rank == 0:
            want = torch.stack([torch.full(sc.SHAPE, 2.0 * (1 + i)) for i in range(2)])
            out["canary_gathered"] = torch.equal(gathered.cpu(), want)
        render_and_hold("config5", mesh, False)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    return out


def device_time_ms(fn, calls=200):
    """Device time per call of ``fn`` (ms) from torch.profiler, or None
    where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def host_us(fn, calls=20000):
    """Host time per call of ``fn`` in us: perf_counter over ``calls``
    calls, the device drained before (what a call enqueues runs on)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launch_breakdown(x):
    """Each step of the canary wrapper's host path timed on its own (host
    clock), beside the whole wrapper and torch.mul; then the steps the
    launch path no longer takes per launch. Returns step -> us per call."""
    import ctypes

    import torch

    from csgrenderer_tpu_torch.kernels import build
    from csgrenderer_tpu_torch.kernels import shard_canary as sc

    kernel, dev = sc._KERNEL, x.device
    out = torch.empty_like(x)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    bind_key = functools.cache(lambda source, symbol, argtypes: None)

    def device_context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "wrapper scale2_kernel (all steps)": functools.partial(sc.scale2_kernel, x),
        "torch.mul(x, 2.0)": functools.partial(torch.mul, x, 2.0),
        "device type check (require_cuda)": functools.partial(kernel.require_cuda, dev),
        "check_tensor": functools.partial(build.check_tensor, x, "x", torch.float32, sc.SHAPE, dev),
        "allocation (torch.empty_like)": functools.partial(torch.empty_like, x),
        "current-device compare": lambda: dev.index == torch.cuda.current_device(),
        "stream lookup (current_stream(index).cuda_stream)":
            lambda: torch.cuda.current_stream(dev.index).cuda_stream,
        "two data_ptr() reads": lambda: (x.data_ptr(), out.data_ptr()),
        "ctypes call, no CUDA (csgr_error_string(0))": functools.partial(kernel.error_string, 0),
        "ctypes call with the launch (csgr_scale2)": functools.partial(kernel.fn, x_ptr, out_ptr,
                                                                       stream),
        "removed: torch.cuda.is_available()": torch.cuda.is_available,
        "removed: functools.cache lookup of (source, symbol, argtypes)": functools.partial(
            bind_key, "shard_canary", "csgr_scale2", (ctypes.c_void_p,) * 3),
        "removed: torch.cuda.device(dev) entered and left": device_context,
        "removed: current_stream(torch.device).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def phase5(card, bench_result, mhz, dev):
    """Phase 5, the parallel path: one process over single_device_mesh(),
    then a two-rank and a four-rank world on the one card (gloo over
    127.0.0.1, spawned interpreters). Returns the canary's kernels-line
    entry."""
    import tempfile

    import torch

    from csgrenderer_tpu_torch.app import PathTraceRenderer
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import shard_canary as sc
    from csgrenderer_tpu_torch.kernels import tape_kernel as tk
    from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
    from csgrenderer_tpu_torch.models import two_spheres_scene
    from csgrenderer_tpu_torch.parallel import render_scene_sharded, single_device_mesh
    from csgrenderer_tpu_torch.parallel.launch import run_ranks
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    for mod in (mk, tk, tm, sc):
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0
    t0 = time.perf_counter()
    kernel = {"sphere": mk.render_image_kernel, "tape": tk.render_image_tape_kernel,
              "trimesh": tm.render_image_mesh_kernel}
    # 1. one process: the sharded path over single_device_mesh() is the kernel's frame
    mesh1, refs, path_launches = single_device_mesh(dev), {}, {}
    for name, mode in SHARD_CASES.items():
        scene, cam, frame = shard_case(name, dev)
        before = launch_counts()
        img, rays = render_scene_sharded(scene, cam, mesh=mesh1, **frame)
        torch.cuda.synchronize()
        path_launches[mode] = launch_counts()[mode] - before[mode]
        ref, ref_rays = kernel[mode.split("_")[0]](scene, cam, **frame)
        same = torch.equal(img, ref) and int(rays) == int(ref_rays)
        print(f"[chip_smoke] phase 5 single_device_mesh {name} {frame['width']}x{frame['height']} "
              f"spp2 ({mode}): {'equal to' if same else 'DIFFERS from'} the unsharded kernel "
              f"frame bit for bit; rays {int(rays)} vs {int(ref_rays)}", flush=True)
        if not same:
            fail(f"phase 5: single_device_mesh {name} is not the kernel's frame")
        refs[name] = (ref.cpu(), int(ref_rays))
    if not all(path_launches.values()):
        fail(f"phase 5: the one-process sharded path launched no kernel: {path_launches}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ref_path = os.path.join(tmp, "refs.pt")
        torch.save(refs, ref_path)
        target = f"{os.path.abspath(__file__)}:phase5_rank"
        t1 = time.perf_counter()
        two = run_ranks(target, 2, args=(ref_path, dev.type), timeout=420)
        t2 = time.perf_counter()
        four = run_ranks(target, 4, args=(ref_path, dev.type), timeout=300)
        t3 = time.perf_counter()
    print(f"[chip_smoke] phase 5 worlds: two ranks {t2 - t1:.1f} s, four ranks {t3 - t2:.1f} s "
          "(spawn, CUDA start-up and renders)", flush=True)
    # 2-3. every comparison the ranks made, on rank 0 of each world
    for chk in two[0]["checks"] + four[0]["checks"]:
        ok_rays = chk["rays"] == chk["ref_rays"]
        ok = chk["equal"] if chk["exact"] else chk["max_abs"] <= 1e-5
        agreement = "bit for bit" if chk["equal"] else f"max |diff| {chk['max_abs']:.3e}"
        print(f"[chip_smoke] phase 5 mesh {chk['mesh']} {chk['name']} {chk['frame']} spp2: "
              f"{agreement} against "
              f"the one-process frame ({'bit for bit' if chk['exact'] else 'atol 1e-5'} required); "
              f"rays {chk['rays']} vs {chk['ref_rays']}", flush=True)
        if not (ok and ok_rays):
            fail(f"phase 5: mesh {chk['mesh']} {chk['name']} disagrees with one process")
    if len(two[0]["checks"]) != 2 * len(SHARD_CASES) or len(four[0]["checks"]) != 1:
        fail("phase 5: a rank skipped a comparison")
    bench = two[0]["bench"]
    times = sorted(bench["times"])
    mrays = bench["rays"] / len(times) / times[len(times) // 2] / 1e6  # as bench.run_bench
    one = bench_result["value"]
    print(f"[chip_smoke] phase 5 RTIOW {bench['frame']} spp{SHARD_BENCH['spp']} "
          f"b{SHARD_BENCH['max_bounces']} lens, mesh 2x1, two ranks on one card: "
          f"{mrays:.1f} Mrays/s (median of {len(times)} frames: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in bench['times'])} ms) vs one process "
          f"{one:.1f} Mrays/s (phase 3's bench; {card})", flush=True)
    cfg = RenderConfig(**NOISE_FRAME)
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=cfg.aspect_ratio,
                         device=dev)
    single = PathTraceRenderer(two_spheres_scene(device=dev), cam, cfg, device=dev)
    acc_s, noise_s, used_s = single.render_to_noise(target=1e-2)
    noises = {(n, u, r) for n, u, r, _ in (res["noise"] for res in two)}
    noise, used, rays, image = two[0]["noise"]
    print(f"[chip_smoke] phase 5 render_to_noise two_spheres {cfg.width}x{cfg.height} target 1e-2 "
          f"chunk {cfg.spp}, mesh 2x1: noise {noise:.6e} at {used} spp vs one process "
          f"{noise_s:.6e} at {used_s} spp; ranks agree: {len(noises) == 1}", flush=True)
    if (len(noises) != 1 or used != used_s or abs(noise - noise_s) > 1e-5 * noise_s
            or rays != acc_s.rays_traced or not torch.equal(image, acc_s.image().cpu())):
        fail("phase 5: render_to_noise_sharded differs from PathTraceRenderer.render_to_noise")
    canary = [res["canary"] for res in four]
    print(f"[chip_smoke] phase 5 canary in 4 ranks (2x2): equal to scale2_plain and "
          f"torch.mul(x, 2.0) bit for bit: {[c[:2] for c in canary]}; gathered "
          f"{four[0]['canary_gathered']}", flush=True)
    if not all(c[0] and c[1] for c in canary) or not four[0]["canary_gathered"]:
        fail("phase 5: the canary kernel is not 2x in every rank")
    # 4. launch checks: every mode of phase 5 launched in a rank
    counts = {}
    for res in two + four:
        for k, n in res["launches"].items():
            counts[k] = counts.get(k, 0) + n
    print(f"[chip_smoke] phase 5 took {time.perf_counter() - t0:.1f} s; launches in the ranks "
          f"{ {k: n for k, n in counts.items() if n} }; in this process {path_launches}",
          flush=True)
    idle = [k for k in (*SHARD_CASES.values(), "shard_canary[scale2]") if counts.get(k, 0) == 0]
    if idle:
        fail(f"kernel modes never launched on the parallel path: {idle}")

    # the canary against its plain version and torch.mul, timed (launches outside the path)
    x = torch.arange(1024, dtype=torch.float32, device=dev).reshape(sc.SHAPE) * 0.37 - 11.0
    got, ms = timed(functools.partial(sc.scale2_kernel, x), reps=1000)
    plain, plain_ms = timed(functools.partial(sc.scale2_plain, x), reps=1000)
    _, library_ms = timed(functools.partial(torch.mul, x, 2.0), reps=1000)
    max_abs = float((got - plain).abs().max())
    if not torch.equal(got, plain):
        fail("the canary kernel differs from scale2_plain")
    device_ms, library_device_ms = (device_time_ms(f) for f in (
        functools.partial(sc.scale2_kernel, x), functools.partial(torch.mul, x, 2.0)))
    io_bytes = 2 * x.numel() * x.element_size()
    ops_ms = x.numel() / (SMS * LANES * mhz * 1e6) * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    breakdown = launch_breakdown(x)
    for step, t in breakdown.items():
        print(f"[chip_smoke] shard_canary[scale2] host path: {step}: {t:.3f} us per call "
              f"(host clock over 20000 calls; {card})", flush=True)

    def us(v):
        return "not measured" if v is None else f"{v * 1e3:.3f} us"

    print(f"[chip_smoke] shard_canary[scale2] [8, 128] f32: kernel {ms * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us, torch.mul {library_ms * 1e3:.2f} us per call (CUDA events "
          f"over 1000 calls: the launch rate); device time per call (torch.profiler): kernel "
          f"{us(device_ms)}, torch.mul {us(library_device_ms)}; bound {bound_ms * 1e3:.5f} us "
          f"({bound_by}: {io_bytes} bytes) ({card})", flush=True)
    source, replaces = KERNELS["shard_canary"]
    return dict(name="shard_canary[scale2]", route="cuda", source=source, replaces=replaces,
                launches=counts["shard_canary[scale2]"], max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                device_ms=device_ms, library_device_ms=library_device_ms, host_us=breakdown)


def atrous_bound(aovs, iterations, mhz):
    """(bound_ms, bound_by, ops, bytes) of the demodulated a-trous filter
    (``render/denoise.py::atrous_denoise``) on these AOVs: the operations
    the function needs, not the kernel's. FP32 operations, expf one each:
    once a pixel, the albedo clamp, divide and multiply (9) and the depth's
    miss select (1); per pixel and pass the centre's luminance (5) and the
    normalisation (max, 3 divides: 4); per tap 23 (luminance difference 1,
    colour weight 3, depth difference 5 (no abs: it is squared), depth
    weight 3, hit gate 1, the weight's product 3, the accumulation 7) and,
    only where both pixels hit, 7 more and the squarings of the normal
    weight (normal dot 5, max, the product; 5 squarings at sigma 32).
    Bytes: colour, albedo, normal (12 each), depth (4) and hit (1) read
    once, the image (12) written once."""
    from csgrenderer_tpu_torch.render.denoise import normal_squarings

    import torch

    h, w = aovs.hit.shape
    hit = aovs.hit
    rows, cols = torch.arange(h, device=hit.device), torch.arange(w, device=hit.device)
    ops = h * w * 10
    for it in range(iterations):
        step = 1 << it
        both = 0
        for dy in range(-2, 3):
            ys = torch.clamp(rows + dy * step, 0, h - 1)
            for dx in range(-2, 3):
                xs = torch.clamp(cols + dx * step, 0, w - 1)
                both += int((hit & hit[ys][:, xs]).sum())
        ops += h * w * (5 + 4 + 25 * 23) + (7 + normal_squarings(32.0)) * both
    nbytes = h * w * (12 + 12 + 12 + 4 + 1 + 12)
    ops_ms = ops / (SMS * LANES * mhz * 1e6) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations", ops, nbytes) if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes", ops, nbytes)


class SpanRecorder:
    """An App renderer that forwards to ``inner`` (an AdaptiveSppRenderer)
    and records each frame's sample span [offset before, offset after) and
    spp, for phase 6's disjointness check."""

    def __init__(self, inner):
        self.inner = inner
        self.spans = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _record(self, draw, t):
        off0, spp = self.inner._offset, self.inner.spp
        out = draw(t)
        self.spans.append((off0, self.inner._offset, spp))
        return out

    def draw_frame(self, t):
        return self._record(self.inner.draw_frame, t)

    def draw_frame_async(self, t):
        return self._record(self.inner.draw_frame_async, t)


def run_demo6(card):
    """``python -m csgrenderer_tpu_torch.demos.demo6_realtime --scene rtiow
    --denoise --serve 0`` in a child process: one /frame fetched from its
    preview server while it runs; returns (frame bytes, content type, the
    demo's fps line). The child is killed on any failure."""
    import urllib.error
    import urllib.request

    cmd = [sys.executable, "-m", "csgrenderer_tpu_torch.demos.demo6_realtime", *DEMO6_ARGS]
    err_path = os.path.join(OUT_DIR, "demo6.stderr")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        lines, url = [], None
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "live preview at" in line:
                url = line.split("live preview at")[1].strip()
                break
        if url is None:
            fail(f"demo 6 printed no preview URL: {lines}")
        frame, ctype, deadline = b"", None, time.perf_counter() + 120
        while not frame and proc.poll() is None and time.perf_counter() < deadline:
            try:
                with urllib.request.urlopen(url + "frame", timeout=5) as resp:
                    frame, ctype = resp.read(), resp.headers["Content-Type"]
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.05)  # 503 until the first frame is published
        rest, _ = proc.communicate(timeout=120)
        lines += rest.splitlines()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in lines:
        print(f"[chip_smoke] demo6: {line}", flush=True)
    if proc.returncode != 0:
        with open(err_path) as f:
            fail(f"demo 6 exited {proc.returncode}: {f.read()[-2000:]}")
    if not frame:
        fail("demo 6 served no frame while it ran")
    fps_line = next((l for l in lines if "fps sustained" in l), "")
    return frame, ctype, fps_line


def gbuffer_bound(packed, counts, width, height, sky, mhz):
    """(bound_ms, bound_by, ops, bytes) of the G-buffer cast: one segment a
    pixel as ``sphere_ops`` counts it (the walk from the plain walk's
    ``counts``), against its tables read once and 29 bytes a pixel written."""
    walk = {k: int(v) for k, v in counts.items()} if packed.grid is not None else None
    ops = sphere_ops(packed.n_brute, width * height, width, height, 1, sky, walk=walk)
    nb = packed.table_bytes + width * height * GBUFFER_BYTES
    ops_ms = ops / (SMS * LANES * mhz * 1e6) * 1e3
    bytes_ms = nb / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations", ops, nb) if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes", ops, nb)


def aov_diff(got, ref):
    """(share of pixels where any channel differs, max abs error over the
    pixels both hit) of two AOVs."""
    import torch

    differ = got.hit != ref.hit
    for a, b in zip(got[:3], ref[:3]):
        d = a != b
        differ |= d.reshape(d.shape[0], d.shape[1], -1).any(dim=-1)
    both = got.hit & ref.hit
    err = max(float((a - b)[both].abs().max()) if bool(both.any()) else 0.0
              for a, b in zip(got[:3], ref[:3]))
    return float(differ.float().mean()), err


def phase6(card, mhz, dev, undenoised):
    """Phase 6, the realtime and denoise path. (a) the sphere kernel's
    G-buffer mode against its plain version, and the a-trous kernel
    against its plain version, at 1280x720 and 1920x1080, the a-trous
    kernel also on a ragged frame at 5 passes (launches outside the path's
    count); then, counts from zero, (b) the denoised realtime frame, (c)
    the adaptive ladder on the night scene through App.run, (d) demo 6
    serving a frame, (e) validate_gpu config 11. ``undenoised``: phase 3's
    (enqueue ms, drained ms) of the rtiow realtime frame. Returns the
    kernels-line entries of the a-trous kernel and the G-buffer mode."""
    import numpy as np
    import torch

    from csgrenderer_tpu_torch.app import AdaptiveSppRenderer, App, PathTraceRenderer, StatsClock
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.kernels import atrous
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.models import night_scene, rtiow_final_scene
    from csgrenderer_tpu_torch.render import denoise, render_aovs
    from csgrenderer_tpu_torch.tools import validate_gpu
    from csgrenderer_tpu_torch.utils.config import RenderConfig

    t_phase = time.perf_counter()
    rtiow = rtiow_final_scene(device=dev)
    packed = mk.pack_scene(rtiow)

    def rtiow_cam(w, h):
        return Camera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=w / h,
                              aperture=0.1, focus_dist=10.0, device=dev)

    # (a) each kernel against its plain version: the G-buffer of the rtiow frame, then the
    # 2-spp beauty frame filtered with it (4 passes; 5 on a ragged frame, so step 16 runs)
    stats, gstats = None, None
    for fw, fh, passes in (*((w, h, 4) for w, h in DENOISE_CHECKS), (*DENOISE_RAGGED, 5)):
        cam = rtiow_cam(fw, fh)
        raw, _ = mk.render_image_kernel(packed, cam, fw, fh, spp=2, max_bounces=8, seed=0,
                                        lens=True)
        aovs, g_ms = timed_queued(functools.partial(mk.render_aovs_kernel, packed, cam, fw, fh),
                                  50, mhz)
        walk = {}  # the plain walk's work on these rays: the bound's operations
        ref_aovs = mk.render_aovs_plain(packed, cam, fw, fh, counts=walk)
        _, g_plain_ms = timed(functools.partial(mk.render_aovs_plain, packed, cam, fw, fh), reps=1)
        brute = render_aovs(rtiow.nearest_hit, cam, fw, fh, sky="rtiow", row_chunk=180)
        share, g_err = aov_diff(aovs, ref_aovs)
        brute_share, _ = aov_diff(aovs, brute)
        g_bound, g_by, g_ops, g_nb = gbuffer_bound(packed, walk, fw, fh, "rtiow", mhz)
        print(f"[chip_smoke] phase 6 sphere G-buffer {fw}x{fh} rtiow ({packed.mode}): "
              f"{share:.4%} of pixels differ from its plain version (max abs {g_err:.3e} where "
              f"both hit; bound {GBUFFER_SHARE:.2%}), {brute_share:.4%} from the plain brute cast; "
              f"kernel {g_ms:.4f} ms, plain (grid walk, torch ops) {g_plain_ms:.3f} ms; bound "
              f"{g_bound:.4f} ms ({g_by}: {g_ops} FP32 ops, {g_nb} bytes) ({card})", flush=True)
        if share > GBUFFER_SHARE or g_err > GBUFFER_TOL:
            fail(f"phase 6: the G-buffer kernel is off its plain version at {fw}x{fh}")
        got, ms = timed_queued(functools.partial(denoise.atrous_denoise, raw, aovs, passes), 50,
                               mhz)
        ref, plain_ms = timed(functools.partial(denoise.atrous_denoise_plain, raw, aovs, passes),
                              reps=3)
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got, ref))
        bound_ms, bound_by, ops, nb = atrous_bound(aovs, passes, mhz)
        verdict = "equal bit for bit" if same else "NOT EQUAL"
        print(f"[chip_smoke] phase 6 atrous {passes} passes {fw}x{fh} on the rtiow 2-spp frame: "
              f"max abs {err:.3e} against the plain version ({verdict}); kernel {ms:.4f} ms, "
              f"plain (eager torch) {plain_ms:.3f} ms for the {passes} passes; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {ops} FP32 ops, {nb} bytes) ({card})", flush=True)
        if not same:
            fail(f"phase 6: the a-trous kernel is {err:.3e} off its plain version at {fw}x{fh}")
        if (fw, fh) == DENOISE_FRAME:  # the realtime frame's: the kernels line's entries
            stats = dict(max_abs_err=err, ms=ms / passes, plain_ms=plain_ms / passes,
                         bound_ms=bound_ms / passes, bound_by=bound_by)
            gstats = dict(max_abs_err=g_err, ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_bound,
                          bound_by=g_by, pixel_share=share, brute_pixel_share=brute_share)

    # the G-buffer cast's two table paths at the realtime frame: on rtiow, staged in shared
    # memory (the size rule's choice) and forced to global memory, bit for bit; on a scene
    # over the shared-memory limit, global memory by the launcher's own choice, against
    # its plain version
    fw, fh = DENOISE_FRAME
    cam = rtiow_cam(fw, fh)
    big = mk.pack_scene(rtiow_final_scene(grid=GBUFFER_BIG_GRID, device=dev))
    casts = {}
    for label, scene_pack, force in (("staged", packed, False), ("forced global", packed, True),
                                     ("over the limit", big, False)):
        before = dict(mk.LAUNCHES_BY_TABLES)
        aovs = mk.render_aovs_kernel(scene_pack, cam, fw, fh, force_global=force)
        torch.cuda.synchronize()
        read = [k for k, n in mk.LAUNCHES_BY_TABLES.items() if n != before[k]]
        casts[label] = (aovs, read)
        print(f"[chip_smoke] phase 6 G-buffer {fw}x{fh} {label}: {scene_pack.scene.num_spheres} "
              f"spheres, {scene_pack.table_bytes} table bytes (limit "
              f"{mk.table_limit(dev.index or 0)}), the cast read {read} memory", flush=True)
    same = all(torch.equal(a, b) for a, b in zip(casts["staged"][0], casts["forced global"][0]))
    big_share, big_err = aov_diff(casts["over the limit"][0],
                                  mk.render_aovs_plain(big, cam, fw, fh))
    print(f"[chip_smoke] phase 6 G-buffer rtiow global vs staged: "
          f"{'equal bit for bit' if same else 'NOT EQUAL'}; over the limit: {big_share:.4%} of "
          f"pixels differ from its plain version (max abs {big_err:.3e} where both hit)",
          flush=True)
    if [r for _, r in casts.values()] != [["shared"], ["global"], ["global"]]:
        fail(f"phase 6: the G-buffer casts read {[r for _, r in casts.values()]} memory")
    if not same:
        fail("phase 6: the G-buffer cast from global memory differs from the staged one")
    if big_share > GBUFFER_SHARE or big_err > GBUFFER_TOL:
        fail("phase 6: the G-buffer cast over the limit is off its plain version")

    for mod in (mk, atrous):
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0
    t0 = time.perf_counter()

    # (b) the denoised realtime frame: rtiow 1280x720, 2 spp, lens, 4 passes
    fw, fh = DENOISE_FRAME
    r = PathTraceRenderer(rtiow, rtiow_cam(fw, fh),
                          RenderConfig(width=fw, height=fh, spp=2, lens=True, denoise=True),
                          advance_samples=True, device=dev)
    r.draw_frame(0.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host wait inside a frame raises
    try:
        t_enqueue = time.perf_counter()
        for i in range(DENOISE_FRAMES):
            r.draw_frame_async(i / 60.0)
            if i == 4:  # a few frames' launches, far below the device's launch queue
                first_ms = (time.perf_counter() - t_enqueue) * 1e3 / 5
        enqueue_ms = (time.perf_counter() - t_enqueue) * 1e3 / DENOISE_FRAMES
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    drained_ms = (time.perf_counter() - t_enqueue) * 1e3 / DENOISE_FRAMES
    print(f"[chip_smoke] phase 6 realtime rtiow {fw}x{fh} spp2 denoised (4 passes): host enqueue "
          f"{enqueue_ms:.3f} ms ({first_ms:.3f} over the first 5), drained {drained_ms:.3f} ms per "
          f"frame ({DENOISE_FRAMES} frames, no host wait inside a frame); undenoised (phase 3): "
          f"enqueue {undenoised[0]:.3f} ms, drained {undenoised[1]:.3f} ms ({card})", flush=True)
    frame_casts = mk.LAUNCHES_BY_MODE["gbuffer"]  # the timed frames' and the warm-up's
    if frame_casts < DENOISE_FRAMES + 1:
        fail(f"phase 6: {DENOISE_FRAMES + 1} denoised frames launched {frame_casts} G-buffer casts")
    # the frame's split, CUDA events: beauty kernel, the renderer's AOV cast (the G-buffer
    # mode over its packed scene), 4 filter passes, tonemap; a 10 ms device sleep first
    # lets the host enqueue the whole frame before the device reaches it, so each interval
    # is device time, not the host's launches
    splits = []
    for i in range(10):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda._sleep(int(mhz * 1e4))
        ev[0].record()
        radiance, _ = r._render(i / 60.0)
        ev[1].record()
        aovs = mk.render_aovs_kernel(r._sphere_pack(i / 60.0), r.camera, fw, fh, sky=r.config.sky)
        ev[2].record()
        den = denoise.atrous_denoise(radiance, aovs, 4)
        ev[3].record()
        r._tonemap(den)
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[k].elapsed_time(ev[k + 1]) for k in range(4)])
    beauty, aov_ms, filt, tone = (float(np.median(c)) for c in zip(*splits))
    _, plain_filter_ms = timed(functools.partial(denoise.atrous_denoise_plain, radiance, aovs, 4),
                               reps=3)
    print(f"[chip_smoke] phase 6 denoised frame split (CUDA events, median of 10): beauty kernel "
          f"{beauty:.3f} ms, AOV cast (the sphere kernel's G-buffer mode, {r._packed.mode}) "
          f"{aov_ms:.4f} ms, a-trous kernel 4 passes {filt:.4f} ms, tonemap {tone:.3f} ms; the "
          f"eager plain filter {plain_filter_ms:.3f} ms ({card})", flush=True)
    app = App(width=fw, height=fh, stats=StatsClock(emit=None), frame_sink=None)
    app.swap_scene(r)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    if not app.run(max_frames=DENOISE_FRAMES, frames_in_flight=2, readback="fence"):
        fail("phase 6: the App loop failed on the denoised frame")
    torch.cuda.synchronize()
    print(f"[chip_smoke] phase 6 App.run denoised rtiow: {DENOISE_FRAMES} frames, 2 in flight, "
          f"readback fence: {DENOISE_FRAMES / (time.perf_counter() - t_run):.1f} fps ({card})",
          flush=True)

    # (c) the adaptive ladder on the night scene (NEE) through App.run
    aw, ah = ADAPTIVE_FRAME
    night_cam = Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0,
                               aspect_ratio=aw / ah, device=dev)
    adaptive = SpanRecorder(AdaptiveSppRenderer(
        night_scene(device=dev), night_cam,
        RenderConfig(width=aw, height=ah, spp=2, max_bounces=8, seed=6, sky="black", nee=True),
        target=0.02, probe_stride=16, device=dev))
    app = App(width=aw, height=ah, stats=StatsClock(emit=None), frame_sink=None)
    app.swap_scene(adaptive)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    if not app.run(max_frames=ADAPTIVE_FRAMES, frames_in_flight=2, readback="fence"):
        fail("phase 6: the App loop failed on the adaptive renderer")
    torch.cuda.synchronize()
    fps = ADAPTIVE_FRAMES / (time.perf_counter() - t_run)
    spans = adaptive.spans
    visited = sorted({s for _, _, s in spans})
    contiguous = all(b - a == s for a, b, s in spans) and all(
        spans[i + 1][0] == spans[i][1] for i in range(len(spans) - 1))
    print(f"[chip_smoke] phase 6 adaptive night {aw}x{ah} nee target 0.02: {len(spans)} frames, "
          f"spp rungs visited {visited}, last spp {adaptive.spp}, last noise "
          f"{adaptive.noise:.4f}, {fps:.1f} fps (2 in flight, readback fence); sample spans "
          f"{'contiguous and disjoint' if contiguous else 'OVERLAP'} over [0, {spans[-1][1]}) "
          f"({card})", flush=True)
    if len(visited) < 2:
        fail(f"phase 6: the adaptive ladder never left its first rung ({visited})")
    if not contiguous:
        fail("phase 6: the adaptive renderer's sample offsets overlap")

    # (d) demo 6 serving a frame; (e) validate_gpu config 11
    frame, ctype, fps_line = run_demo6(card)
    print(f"[chip_smoke] phase 6 demo6 --scene rtiow --denoise --serve 0: one /frame of "
          f"{len(frame)} bytes ({ctype}) fetched while it ran ({card})", flush=True)
    rc = validate_gpu.main(["--only", "config11"])
    torch.cuda.synchronize()
    counts = {"atrous[pass]": atrous.LAUNCHES_BY_MODE["pass"],
              **{f"sphere_megakernel[{m}]": n for m, n in mk.LAUNCHES_BY_MODE.items()}}
    print(f"[chip_smoke] phase 6 path took {time.perf_counter() - t0:.1f} s (phase "
          f"{time.perf_counter() - t_phase:.1f} s); launches {counts}", flush=True)
    if rc != 0:
        fail("validate_gpu --only config11 failed")
    idle = [k for k in ("atrous[pass]", "sphere_megakernel[grid]", "sphere_megakernel[brute-nee]",
                        "sphere_megakernel[gbuffer]") if counts[k] == 0]
    if idle:
        fail(f"kernel modes never launched on the realtime and denoise path: {idle}")
    source, replaces = KERNELS["atrous"]
    entries = [dict(name="atrous[pass]", route="cuda", source=source, replaces=replaces,
                    launches=counts["atrous[pass]"], **stats, library_ms=None)]
    source, _ = KERNELS["sphere_megakernel"]
    entries.append(dict(name="sphere_megakernel[gbuffer]", route="cuda", source=source,
                        replaces=GBUFFER_REPLACES, launches=counts["sphere_megakernel[gbuffer]"],
                        **gstats, library_ms=None))
    return entries


def run_demo_main(name, argv):
    """``csgrenderer_tpu_torch.demos.<name>.main(argv)`` in this process;
    returns its stdout lines (each printed with the demo's name, but the
    per-file "wrote" lines). Fails on a non-zero exit."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"csgrenderer_tpu_torch.demos.{name}")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv))
    except SystemExit as e:
        rc = e.code
    lines = buf.getvalue().splitlines()
    for line in lines:
        if "[csgr] wrote " not in line:
            print(f"[chip_smoke] {name}: {line}", flush=True)
    if rc not in (None, 0):
        fail(f"phase 7: {name} {' '.join(argv)} exited {rc}")
    return lines


def check_png(path):
    """The PNG at ``path`` as a uint8 array; fails if it is missing or
    constant."""
    from csgrenderer_tpu_torch.io import read_png

    if not os.path.isfile(path):
        fail(f"phase 7: no PNG at {path}")
    img = read_png(path)
    if int(img.max()) == int(img.min()):
        fail(f"phase 7: {path} is constant")
    return img


def phase7(card, dev, bench_rtiow):
    """Phase 7: the demos on the card through their ``main(argv)``, counts
    from zero; see the module docstring. ``bench_rtiow`` is phase 3's
    sphere benchmark result, the same scene and frame as demo 4's."""
    import re

    import numpy as np
    import torch

    from csgrenderer_tpu_torch.demos.demo3_csg_boolean import native_tape
    from csgrenderer_tpu_torch.io import write_obj
    from csgrenderer_tpu_torch.kernels import megakernel as mk
    from csgrenderer_tpu_torch.kernels import tape_kernel as tk
    from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
    from csgrenderer_tpu_torch.models import config3_csg_scene, mesh_demo_scene

    work = os.path.join(OUT_DIR, "demos")
    os.makedirs(work, exist_ok=True)
    mods = {"sphere_megakernel": mk, "tape_kernel": tk, "trimesh_kernel": tm}
    for mod in mods.values():
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0

    def modes():
        return {f"{name}[{m}]": n for name, mod in mods.items()
                for m, n in mod.LAUNCHES_BY_MODE.items()}

    def run(name, label, argv, must_launch=()):
        """One demo run; the kernel modes it launched (those in
        ``must_launch`` must be among them) and its stdout lines."""
        before = modes()
        t_run = time.perf_counter()
        lines = run_demo_main(name, [*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in modes().items() if n != before[k]}
        print(f"[chip_smoke] phase 7 {label}: {time.perf_counter() - t_run:.1f} s, launches "
              f"{launched or 'none'}", flush=True)
        idle = [m for m in must_launch if not launched.get(m)]
        if idle:
            fail(f"phase 7: {label} never launched {idle}")
        return lines

    def out(label):
        return os.path.join(work, label)

    t0 = time.perf_counter()
    # demo 1: the reference shader's frame, torch ops (no kernel; fault C-6)
    run("demo1_sphere_normals", "demo1", ["--out", out("d1")])
    check_png(os.path.join(out("d1"), "milestone01_0000.png"))
    # demo 2: 800x450, 16 spp, two spheres: sphere brute
    run("demo2_diffuse_spheres", "demo2", ["--out", out("d2")], ["sphere_megakernel[brute]"])
    check_png(os.path.join(out("d2"), "diffuse_0000.png"))
    # demo 3: 512x512, 16 spp, from the Python graph and through the native scene core
    tape_modes = [f"tape_kernel[{tk.pack_program(config3_csg_scene().compile(device=dev)).mode}]"]
    run("demo3_csg_boolean", "demo3", ["--out", out("d3")], tape_modes)
    run("demo3_csg_boolean", "demo3 --native", ["--native", "--out", out("d3n")], tape_modes)
    py_img = check_png(os.path.join(out("d3"), "csg_0000.png"))
    nat_img = check_png(os.path.join(out("d3n"), "csg_0000.png"))
    py_tape, nat_tape = config3_csg_scene().compile(), native_tape()
    tapes_equal = all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for a, b in ((getattr(py_tape, f), getattr(nat_tape, f))
                     for f in py_tape.__dataclass_fields__))
    differ = float((py_img != nat_img).any(axis=-1).mean())
    image = "equal bit for bit" if differ == 0 else f"{differ:.4%} of pixels differ"
    print(f"[chip_smoke] phase 7 demo3 --native: tapes {'equal' if tapes_equal else 'NOT equal'} "
          f"field by field; image {image} to the Python graph's", flush=True)
    if differ:
        if tapes_equal:
            fail("phase 7: demo 3's native image differs from the Python graph's on equal tapes")
        compare("phase 7 demo3 --native vs the Python graph (uint8 / 255)",
                torch.from_numpy(py_img / 255.0), 0, torch.from_numpy(nat_img / 255.0), 0)
    # demo 4: the main path's frame, 1920x1080, 64 spp, 8 bounces, 3 frames: sphere grid
    lines = run("demo4_rtiow_final", "demo4", ["--frames", "3", "--out", out("d4")],
                ["sphere_megakernel[grid]"])
    for i in range(3):
        check_png(os.path.join(out("d4"), f"rtiow_{i:04d}.png"))
    stats = next((l for l in lines if "[Stats]" in l), "")
    m = re.search(r"([\d.]+) Mrays/s", stats)
    if m is None:
        fail(f"phase 7: demo 4 printed no Mrays/s: {stats!r}")
    print(f"[chip_smoke] phase 7 demo4 rtiow 1920x1080 spp64: {float(m.group(1)):.1f} Mrays/s "
          f"(mean over 3 frames, render only) beside phase 3's bench rtiow "
          f"{bench_rtiow['value']:.1f} Mrays/s (median of {bench_rtiow['frames']} frames) ({card})",
          flush=True)
    # demo 5: 4K, 2 spp, 5 bounces: 4 frames and a checkpoint, 2 more resumed, against 6
    # uninterrupted; the orbit; render-to-noise at 512x512
    ck = {k: os.path.join(work, f"demo5_{k}.npz") for k in ("four", "resumed", "six")}
    tape5 = ["tape_kernel[clustered]"]
    run("demo5_animated_csg", "demo5 4 frames", ["--checkpoint", ck["four"], "--out", out("d5")],
        tape5)
    run("demo5_animated_csg", "demo5 --resume 2 frames",
        ["--frames", "2", "--resume", ck["four"], "--checkpoint", ck["resumed"],
         "--out", out("d5r")], tape5)
    run("demo5_animated_csg", "demo5 6 frames",
        ["--frames", "6", "--checkpoint", ck["six"], "--out", out("d5s")], tape5)
    check_png(os.path.join(out("d5r"), "deepcsg_0001.png"))
    with np.load(ck["resumed"]) as a, np.load(ck["six"]) as b:
        same = {k: a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in b.files}
        counts = (int(a["sample_count"]), int(a["rays_traced"]), int(b["sample_count"]),
                  int(b["rays_traced"]))
    print(f"[chip_smoke] phase 7 demo5 4K: 4 + 2 resumed frames against 6 uninterrupted: "
          f"{same} (spp {counts[0]} vs {counts[2]}, rays {counts[1]} vs {counts[3]})", flush=True)
    if not all(same.values()):
        fail("phase 7: demo 5's resumed accumulation differs from the uninterrupted one")
    run("demo5_animated_csg", "demo5 --orbit", ["--frames", "2", "--orbit", "--out", out("d5o")],
        ["tape_kernel[global]"])
    check_png(os.path.join(out("d5o"), "deepcsg_0001.png"))
    run("demo5_animated_csg", "demo5 --target-noise 1e-2 512x512",
        ["--width", "512", "--height", "512", "--target-noise", "1e-2", "--out", out("d5t")],
        tape5)
    check_png(os.path.join(out("d5t"), "deepcsg_0000.png"))
    # demo 7: the mesh kernel's grid, brute and grid-nee modes, a larger mesh and an OBJ
    for label, argv, must in (
        ("demo7", [], ["trimesh_kernel[grid]"]),
        ("demo7 --worklist off", ["--worklist", "off"], ["trimesh_kernel[brute]"]),
        ("demo7 --nee", ["--nee"], ["trimesh_kernel[grid-nee]"]),
        ("demo7 --subdiv 4", ["--subdiv", "4"], ["trimesh_kernel[grid]"]),
    ):
        png = out(label.replace(" ", "").replace("--", "_") + ".png")
        run("demo7_mesh", label, [*argv, "--out", png], must)
        check_png(png)
    obj = os.path.join(work, "mesh.obj")
    m1 = mesh_demo_scene(1)  # 242 faces as a triangle soup: the mesh kernel's grid mode
    write_obj(obj, torch.cat([m1.v0, m1.v0 + m1.e1, m1.v0 + m1.e2]).numpy(),
              np.arange(3 * m1.num_faces).reshape(3, -1).T)
    png = out("demo7_obj.png")
    run("demo7_mesh", "demo7 --obj", ["--obj", obj, "--out", png], ["trimesh_kernel[grid]"])
    check_png(png)
    # demos 8 and 9: the night scenes with and without NEE
    for name, label, argv, must in (
        ("demo8_night", "demo8 --nee", ["--nee"], ["sphere_megakernel[brute-nee]"]),
        ("demo8_night", "demo8 --no-nee", ["--no-nee"], ["sphere_megakernel[brute]"]),
        ("demo9_csg_night", "demo9 --nee", ["--nee"], ["tape_kernel[clustered-nee]"]),
        ("demo9_csg_night", "demo9 --no-nee", ["--no-nee"], ["tape_kernel[clustered]"]),
    ):
        png = out(label.replace(" ", "").replace("--", "_") + ".png")
        run(name, label, [*argv, "--out", png], must)
        check_png(png)
    counts = modes()
    print(f"[chip_smoke] phase 7 took {time.perf_counter() - t0:.1f} s; launches {counts} ({card})",
          flush=True)
    # the frames stay small enough to bring back; the 4K ones and the checkpoints do not
    for root, _, files in os.walk(work):
        for f in files:
            path = os.path.join(root, f)
            if os.path.getsize(path) > (4 << 20):
                os.remove(path)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from csgrenderer_tpu_torch import bench
    from csgrenderer_tpu_torch.__main__ import main as cli_main
    from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock, WololoRenderer
    from csgrenderer_tpu_torch.app.goldens import golden_renderers
    from csgrenderer_tpu_torch.io import read_png, rmse
    from csgrenderer_tpu_torch.utils.config import RenderConfig
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
    from csgrenderer_tpu_torch.tools import (exp_dot_k, exp_gather, exp_slab, shadow_walk_probe,
                                             validate_gpu)

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

    def sphere_walk_counts(packed, cam, kw):
        """The plain grid walk's work over the frame's path segments (NEE
        adds shadow rays, never segments, so a run without it has the same)."""
        counts = {}
        mk.render_image_plain(packed, cam, counts=counts,
                              **{k: v for k, v in kw.items() if k != "nee"})
        return {k: int(v) for k, v in counts.items()}

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

    def tables_used(label, packed, before):
        """Where the sphere kernel's launches since ``before`` read their
        tables (staged in shared memory, or global: the launcher's choice
        by size), printed with the size and the device's limit."""
        used = "+".join(k for k, n in mk.LAUNCHES_BY_TABLES.items() if n > before[k])
        print(f"[chip_smoke] {label}: tables in {used} memory ({packed.table_bytes} bytes; a CTA "
              f"stages up to {mk.table_limit(dev.index or 0)})", flush=True)
        return used

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
        kw = dict(width=w, height=h, max_bounces=8, seed=0, **extra)
        tables0 = dict(mk.LAUNCHES_BY_TABLES)
        max_abs, ms, plain_ms, _, rays = check(label, packed, cam, mode, kw, plain_reps=1)
        stats[f"sphere_megakernel[{mode}]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                                   tables=tables_used(label, packed, tables0))
        walk = sphere_walk_counts(packed, cam, kw) if mode == "grid" else None
        frames[f"sphere_megakernel[{mode}]"] = (
            sphere_ops(packed.n_brute, rays, w, h, extra["spp"], walk=walk),
            nbytes(packed.spheres) + (0 if packed.grid is None else nbytes(packed.grid.cell_ids)),
            w, h, "" if walk is None else f"; walk {walk}",
        )

    # the sphere kernel's two table paths at the grid frame: the tables staged in
    # shared memory (the size rule's choice) and read from global memory (forced)
    packed = mk.pack_scene(rtiow)
    args = (packed, mk.pack_camera(rtiow_cam(w / h)).contiguous(), w, h, 2, 8, 0, 0, True,
            "rtiow", False)
    (img_s, rays_s), ms_s = timed(functools.partial(mk._launch, *args), reps=5)
    (img_g, rays_g), ms_g = timed(functools.partial(mk._launch, *args, force_global=True), reps=5)
    same = torch.equal(img_s, img_g) and int(rays_s) == int(rays_g)
    print(f"[chip_smoke] grid rtiow {w}x{h} spp2 b8 lens: tables in shared memory {ms_s:.3f} ms, "
          f"in global memory {ms_g:.3f} ms; images {'equal' if same else 'DIFFER'} bit for bit "
          f"({card})", flush=True)
    if not same:
        fail("the sphere kernel's shared-memory and global-memory tables give other images")

    # the tape kernel
    tape_check = functools.partial(check, kernel=tk.render_image_tape_kernel,
                                   plain=tk.render_image_tape_plain)

    def tape_tables(label, packed):
        """The tape kernel stages its tables in every CTA's shared memory
        (the 255 leaves of many_objects_scene(127) need 24,000 bytes);
        printed with their size and the interval arrays' cap."""
        print(f"[chip_smoke] {label}: tables in shared memory ({packed.table_bytes} bytes), "
              f"interval arrays of {packed.interval_cap} slots", flush=True)
        return "shared"
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
        stats[f"tape_kernel[{mode}]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                             tables=tape_tables(f"tape config5 {mode}", packed))
        frames[f"tape_kernel[{mode}]"] = (
            tape_ops(packed, rays, w5, h5, kw5["spp"]), nbytes(packed.tables), w5, h5, "",
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
        tables0 = dict(mk.LAUNCHES_BY_TABLES)
        max_abs, ms, plain_ms, img, rays = check(
            f"{mode}-nee {label} {wn}x{hn} spp2 b{bn}", packed, night_cam, mode, kwn, plain_reps=1)
        night_runs[label] = (scene, mode, ms, img, rays)
        name = f"sphere_megakernel[{mode}-nee]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           tables=tables_used(f"{mode}-nee {label}", packed, tables0))
        c = plain_counts(mk.render_image_plain, packed, night_cam)
        # the kernel's own shadow-ray count, held to the plain version's as
        # compare() holds the segments
        kc = {}
        mk.render_image_kernel(packed, night_cam, counts=kc, **kwn)
        k_shadow = int(kc["shadow_rays"])
        print(f"[chip_smoke] {mode}-nee {label} {wn}x{hn} spp2 b{bn}: kernel {k_shadow} shadow "
              f"rays, plain {c['shadow_rays']} ({card})", flush=True)
        if abs(k_shadow - c["shadow_rays"]) > max(2e-3 * c["shadow_rays"], 8):
            fail(f"{mode}-nee {label}: the kernel counts {k_shadow} shadow rays, the plain "
                 f"version {c['shadow_rays']}")
        n_brute = packed.n_brute
        walk = sphere_walk_counts(packed, night_cam, kwn) if mode == "grid" else None
        frames[name] = (
            sphere_ops(n_brute, rays, wn, hn, 2, "black", walk) + nee_ops(
                c, OPS["ray"] + 1, n_brute * OPS["sphere_test"], OPS["sphere_test"],
                OPS["partner"]),
            nbytes(packed.spheres, packed.lamps)
            + (0 if packed.grid is None else nbytes(packed.grid.cell_ids)),
            wn, hn, f"; {c['shadow_rays']} shadow rays, kernel {k_shadow} "
            f"({c['shadow_clear']} reach the lamp)"
            + ("" if walk is None else f"; walk {walk}"),
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
    stats["tape_kernel[clustered-nee]"] = dict(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
        tables=tape_tables("tape csgnight clustered-nee", packed))
    c = plain_counts(tk.render_image_tape_plain, packed, csg_cam)
    n_lamps = packed.lamp_ids.numel()
    frames["tape_kernel[clustered-nee]"] = (
        tape_ops(packed, rays_c, wn, hn, 2, "black") + nee_ops(
            c, 1, leaf_interval_ops(packed, range(packed.tape.n_leaves))
            + 2 * packed.tape.n_leaves * OPS["candidate_test"],
            leaf_interval_ops(packed, packed.clusters[0][1]),
            OPS["partner"] + n_lamps * OPS["lamp_match"]),
        nbytes(packed.tables), wn, hn,
        f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
    )
    packed_g = tk.pack_program(night_tape, False)
    max_abs, ms_g, plain_ms, img_g, rays_g = tape_check(
        f"tape csgnight global-nee {wn}x{hn} spp2 b{bn}", packed_g, csg_cam, "global", kwn,
        plain_reps=1)
    stats["tape_kernel[global-nee]"] = dict(
        max_abs_err=max_abs, ms=ms_g, plain_ms=plain_ms,
        tables=tape_tables("tape csgnight global-nee", packed_g))
    c = plain_counts(tk.render_image_tape_plain, packed_g, csg_cam)
    all_leaves = range(packed_g.tape.n_leaves)
    frames["tape_kernel[global-nee]"] = (
        tape_ops(packed_g, rays_g, wn, hn, 2, "black") + nee_ops(
            c, 1, leaf_interval_ops(packed_g, all_leaves)
            + 2 * packed_g.tape.n_leaves * OPS["candidate_test"],
            leaf_interval_ops(packed_g, packed_g.clusters[0][1]),
            OPS["partner"] + n_lamps * OPS["lamp_match"]),
        nbytes(packed_g.tables), wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
    )
    compare(f"tape csgnight {wn}x{hn} kernel global-nee vs kernel clustered-nee", img_c, rays_c,
            img_g, rays_g)
    print(f"[chip_smoke] tape csgnight {wn}x{hn} spp2 b{bn}: kernel clustered-nee {ms:.3f} ms, "
          f"global-nee {ms_g:.3f} ms ({card})", flush=True)

    # --- the tape kernel's interval-list audit mode (with_overflow=True)
    def pearls(k):
        """tests/test_interval_overflow.py's three disjoint spheres along +z:
        three spans on the axis, more than k = 2 slots hold."""
        g = SceneGraph()
        s1, s2, s3 = (g.add_sphere_node(0.4, Material.lambertian(c))
                      for c in ((0.8, 0.2, 0.2), (0.2, 0.8, 0.2), (0.2, 0.2, 0.8)))
        u = g.add_union_of_node(NodeArgument(s1, offset=(0, 0, 2.0)),
                                NodeArgument(s2, offset=(0, 0, 4.0)))
        g.add_union_of_node(NodeArgument(u), NodeArgument(s3, offset=(0, 0, 6.0)))
        return g.compile(k=k, device=dev)

    def audit_check(label, packed, cam, kw, exact, plain_reps=0):
        """The audit kernel against its plain version: image and rays by
        compare(), the dropped-span count exactly (``exact``) or within
        the rays' bound. Returns (max_abs, ms, plain_ms, image, rays, over)."""
        run = functools.partial(tk.render_image_tape_kernel, packed, cam, with_overflow=True, **kw)
        run_plain = functools.partial(tk.render_image_tape_plain, packed, cam, with_overflow=True,
                                      **kw)
        if plain_reps:
            (img, rays, over), ms = timed(run, reps=5)
            (ref, ref_rays, ref_over), plain_ms = timed(run_plain, reps=plain_reps)
            print(f"[chip_smoke] {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})",
                  flush=True)
        else:
            (img, rays, over), ms, plain_ms = run(), None, None
            torch.cuda.synchronize()
            ref, ref_rays, ref_over = run_plain()
            torch.cuda.synchronize()
        _, _, max_abs = compare(f"{label} kernel vs plain", ref, ref_rays, img, rays)
        over, ref_over = int(over), int(ref_over)
        allowed = 0 if exact else max(2e-3 * ref_over, 8)
        print(f"[chip_smoke] {label}: dropped spans {over} vs plain {ref_over} "
              f"(allowed difference {allowed})", flush=True)
        if abs(over - ref_over) > allowed:
            fail(f"{label}: the dropped-span counts differ")
        return max_abs, ms, plain_ms, img, rays, over

    pearl_cam = cam_at((0, 0, -6), (0, 0, 1), 30.0, 1.0)
    for k, kw, exact in ((2, dict(spp=1, max_bounces=1), True), (2, dict(spp=2, max_bounces=3), False),
                         (4, dict(spp=1, max_bounces=1), True)):
        over = audit_check(f"audit pearls k={k} 256x256 spp{kw['spp']} b{kw['max_bounces']}",
                           tk.pack_program(pearls(k)), pearl_cam,
                           dict(width=256, height=256, seed=0, **kw), exact)[5]
        if (over > 0) != (k == 2):
            fail(f"audit pearls k={k}: {over} dropped spans (k = 2 must drop, k = 4 must not)")
    packed = tk.pack_program(tape5)
    max_abs, ms, plain_ms, _, rays, _ = audit_check(
        f"audit config5 k=4 {w5}x{h5} spp2 b{b5}", packed, cam5, kw5, True, plain_reps=1)
    stats["tape_kernel[audit]"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                       tables=tape_tables("audit config5", packed))
    frames["tape_kernel[audit]"] = (
        audit_ops(packed, rays, w5, h5, kw5["spp"]),
        nbytes(packed.tables) + w5 * h5 * 4,  # + the int32 over plane
        w5, h5, "",
    )
    print(f"[chip_smoke] config5 {w5}x{h5} spp2 b{b5}: kernel audit {ms:.3f} ms vs event flip "
          f"clustered {stats['tape_kernel[clustered]']['ms']:.3f} ms, global "
          f"{stats['tape_kernel[global]']['ms']:.3f} ms ({card})", flush=True)
    audit_check("audit-nee csgnight 320x180 spp2 b6", tk.pack_program(night_tape),
                cam_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), 38.0, 320 / 180),
                dict(width=320, height=180, spp=2, max_bounces=bn, seed=0, sky="black", nee=True),
                False)
    packed_n = tk.pack_program(night_tape)  # clustered: the shadow rays' event flip
    max_abs, ms_a, plain_ms, _, rays_a, _ = audit_check(
        f"audit-nee csgnight {wn}x{hn} spp2 b{bn}", packed_n, csg_cam, kwn, False, plain_reps=1)
    stats["tape_kernel[audit-nee]"] = dict(max_abs_err=max_abs, ms=ms_a, plain_ms=plain_ms,
                                           tables=tape_tables("audit-nee csgnight", packed_n))
    c = plain_counts(tk.render_image_tape_plain, packed_n, csg_cam)
    frames["tape_kernel[audit-nee]"] = (
        audit_ops(packed_n, rays_a, wn, hn, 2, "black") + nee_ops(
            c, 1, leaf_interval_ops(packed_n, all_leaves)
            + 2 * packed_n.tape.n_leaves * OPS["candidate_test"],
            leaf_interval_ops(packed_n, packed_n.clusters[0][1]),
            OPS["partner"] + n_lamps * OPS["lamp_match"]),
        nbytes(packed_n.tables) + wn * hn * 4,
        wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach the lamp)",
    )
    print(f"[chip_smoke] csgnight {wn}x{hn} spp2 b{bn}: kernel audit-nee {ms_a:.3f} ms vs "
          f"clustered-nee {stats['tape_kernel[clustered-nee]']['ms']:.3f} ms, global-nee "
          f"{ms_g:.3f} ms ({card})", flush=True)

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

    def mesh_tables(label, packed, before):
        """Where the mesh kernel's launches since ``before`` read their
        tables (the launcher's choice by size), printed with the size."""
        used = "+".join(k for k, n in tm.LAUNCHES_BY_TABLES.items() if n > before[k])
        print(f"[chip_smoke] {label}: tables in {used} memory ({packed.table_bytes} bytes; a CTA "
              f"stages up to {tm.table_limit(dev.index or 0)})", flush=True)
        return used

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
        tables0 = dict(tm.LAUNCHES_BY_TABLES)
        max_abs, ms, plain_ms, img, rays = mesh_check(
            f"mesh {mode} {label} {wm}x{hm} spp2 b6", packed, cam_m, mode, kwm, plain_reps=1)
        name = f"trimesh_kernel[{mode}]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           tables=mesh_tables(f"mesh {mode} {label}", packed, tables0))
        walk = walk_counts(packed, cam_m, kwm) if mode == "grid" else None
        frames[name] = (
            mesh_ops(packed, rays, wm, hm, 2, walk=walk), nbytes(packed.faces, packed.tables),
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
        tables0 = dict(tm.LAUNCHES_BY_TABLES)
        max_abs, ms, plain_ms, img, rays = mesh_check(
            f"mesh {mode}-nee {label} {wn}x{hn} spp2 b{bn}", packed, cam, mode, kwmn, plain_reps=1)
        name = f"trimesh_kernel[{mode}-nee]"
        stats[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           tables=mesh_tables(f"mesh {mode}-nee {label}", packed, tables0))
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
            nbytes(packed.faces, packed.tables, packed.lamps), wn, hn, f"; {c['shadow_rays']} shadow rays ({c['shadow_clear']} reach a lamp)"
            + ("" if walk is None else f"; walk {walk}"),
        )
    # the mesh kernel's two table paths at the grid-nee frame: the tables staged in
    # shared memory (the size rule's choice for meshnight) and read from global memory
    packed = tm.pack_mesh(mesh_night_scene(device=dev))
    args = (packed, mk.pack_camera(mesh_cam((0, 1.8, 2.4), wn, hn)).contiguous(), wn, hn, 2, bn,
            0, 0, False, "black", True)
    (img_s, rays_s), ms_s = timed(functools.partial(tm._launch, *args), reps=5)
    (img_g, rays_g), ms_g = timed(functools.partial(tm._launch, *args, force_global=True), reps=5)
    same = torch.equal(img_s, img_g) and int(rays_s) == int(rays_g)
    print(f"[chip_smoke] mesh grid-nee meshnight {wn}x{hn} spp2 b{bn}: tables in shared memory "
          f"{ms_s:.3f} ms, in global memory {ms_g:.3f} ms; images {'equal' if same else 'DIFFER'} "
          f"bit for bit ({card})", flush=True)
    if not same:
        fail("the mesh kernel's shared-memory and global-memory tables give other images")
    # ROADMAP C-7: config 7's launch on the grid-nee build as shipped, in a child process
    # under a time limit, three times; each must trace the segments every other build does
    t_c7 = time.perf_counter()
    counts7 = shadow_walk_probe.config7_counts(repeats=3, timeout=120.0)
    print(f"[chip_smoke] C-7 probe: config 7's launch (96x54, 1,024 spp at offset 6,144) traced "
          f"{counts7} segments, expected {shadow_walk_probe.CONFIG7_SEGMENTS} three times "
          f"({time.perf_counter() - t_c7:.1f} s)", flush=True)
    if counts7 != [shadow_walk_probe.CONFIG7_SEGMENTS] * 3:
        fail("C-7: the grid-nee kernel did not trace config 7's launch right three times")

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

    # row slabs: each kernel's slabs of its main-path frame are the frame's rows, bit for bit
    for label, kernel, packed, cam, kw in (
        ("sphere grid rtiow", mk.render_image_kernel, mk.pack_scene(rtiow), rtiow_cam(w / h),
         dict(width=w, height=h, spp=2, max_bounces=8, seed=0, lens=True)),
        ("tape clustered config5", tk.render_image_tape_kernel, tk.pack_program(tape5), cam5,
         kw5),
        ("mesh grid mesh_demo_scene(4)", tm.render_image_mesh_kernel,
         tm.pack_mesh(mesh_demo_scene(4, device=dev)), cam_m, kwm),
    ):
        full, rays = kernel(packed, cam, **kw)
        height = kw["height"]
        cuts = (0, height // 3, height // 3 + height // 2, height)
        parts, total = [], 0
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            img, r = kernel(packed, cam, rows=hi - lo, row_offset=lo, **kw)
            parts.append(img)
            total += int(r)
        same = torch.equal(torch.cat(parts), full)
        print(f"[chip_smoke] slabs {label} {kw['width']}x{height}: rows {cuts} "
              f"{'equal' if same else 'DIFFER from'} the frame's bit for bit; rays {total} vs "
              f"{int(rays)}", flush=True)
        if not same or total != int(rays):
            fail(f"slabs {label}: not the full frame's rows")

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
    for tables in (mk.LAUNCHES_BY_TABLES, tm.LAUNCHES_BY_TABLES):
        for k in tables:
            tables[k] = 0
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

    # the audit at the deepcsg bench frame, k = 4: exact, and the event flip's image
    packed5 = tk.pack_program(tape5)
    ev_img, ev_rays = tk.render_image_tape_kernel(packed5, cam5, **kw5)
    au_img, au_rays, au_over = tk.render_image_tape_kernel(packed5, cam5, with_overflow=True, **kw5)
    differ = float((au_img != ev_img).any(dim=-1).float().mean())
    print(f"[chip_smoke] audit config5 k=4 {w5}x{h5} spp2 b{b5}: {int(au_over)} dropped spans; "
          f"image {'equal to' if differ == 0.0 else f'{differ:.4%} of pixels off'} the event-flip "
          f"kernel's; rays {int(au_rays)} vs {int(ev_rays)}", flush=True)
    if int(au_over) != 0:
        fail("the audit finds config5 at k = 4 inexact")
    if differ:
        compare("audit config5 vs event-flip kernel", ev_img, ev_rays, au_img, au_rays)
    _, _, n_over = tk.render_image_tape_kernel(tk.pack_program(night_tape), csg_cam,
                                               with_overflow=True, **kwn)
    print(f"[chip_smoke] audit-nee csgnight k=4 {wn}x{hn} spp2 b{bn}: {int(n_over)} dropped spans",
          flush=True)

    # tools/make_goldens.py's configs through the renderers, against the CPU's plain versions
    for name, make in golden_renderers("cuda").items():
        r, t_sec = make()
        frame = r.draw_frame(t_sec)
        r_cpu, _ = golden_renderers("cpu")[name]()
        ref = r_cpu.draw_frame(t_sec)
        err = rmse(frame.cpu().numpy(),
                   read_png(os.path.join(REPO, "tests", "goldens", f"{name}.png")))
        print(f"[chip_smoke] golden {name}: RMSE {err:.3e} to the golden (the JAX reference under "
              f"XLA's jit)", flush=True)
        compare(f"golden {name} renderer cuda vs cpu (uint8 / 255)", ref.to(dev).float() / 255.0,
                r_cpu.last_frame_rays, frame.float() / 255.0, r.last_frame_rays)

    # gif --scene deepcsg: the animated tape reclustered on the host, one launch per frame
    launches0, modes0 = tk.LAUNCHES, dict(tk.LAUNCHES_BY_MODE)
    gif = os.path.join(OUT_DIR, "deepcsg.gif")
    cli_main(["gif", "--scene", "deepcsg", "--frames", "4", "--width", "640", "--height", "360",
              "--spp", "4", "--bounces", "5", "--device", "cuda", "--out", gif])
    gif_modes = {m: n - modes0[m] for m, n in tk.LAUNCHES_BY_MODE.items() if n != modes0[m]}
    print(f"[chip_smoke] gif deepcsg 4 frames: tape launches {tk.LAUNCHES - launches0} "
          f"{gif_modes}", flush=True)
    if tk.LAUNCHES - launches0 != 4 or not os.path.isfile(gif):
        fail("gif --scene deepcsg did not launch the tape kernel once per frame")

    # the realtime cell: App.run with frames in flight, 1280x720, 2 spp; every
    # frame reaches the host (the serial loop's sink copies it there itself),
    # but for "fence", which reads one ray count per frame
    def to_host(i, frame):
        return frame.cpu().numpy() if isinstance(frame, torch.Tensor) else frame

    realtime_ms = {}  # label -> (host enqueue, drained) ms a frame
    for label, r in (
        ("rtiow", PathTraceRenderer(rtiow, rtiow_cam(1280 / 720),
                                    RenderConfig(width=1280, height=720, spp=2, lens=True),
                                    advance_samples=True)),
        ("wololo", WololoRenderer(RenderConfig(width=1280, height=720, spp=1, sky="wololo"))),
    ):
        r.draw_frame(0.0)  # warm-up
        for in_flight, readback in ((2, "full"), (1, "full"), (2, "fence")):
            fps = []
            for _ in range(REALTIME_REPEATS):
                app = App(width=1280, height=720, stats=StatsClock(emit=None),
                          frame_sink=to_host if readback == "full" else None)
                app.swap_scene(r)
                torch.cuda.synchronize()
                t_run = time.perf_counter()
                if not app.run(max_frames=REALTIME_FRAMES, frames_in_flight=in_flight,
                               readback=readback):
                    fail(f"realtime {label}: the App loop failed")
                torch.cuda.synchronize()
                fps.append(REALTIME_FRAMES / (time.perf_counter() - t_run))
            mid = sorted(fps)[len(fps) // 2]
            print(f"[chip_smoke] realtime {label} 1280x720 spp{r.config.spp}: {REALTIME_REPEATS} "
                  f"runs of {REALTIME_FRAMES} frames, {in_flight} in flight, readback {readback}: "
                  f"{', '.join(f'{x:.1f}' for x in fps)} fps (median {mid:.1f}, spread "
                  f"{(max(fps) - min(fps)) / mid:.1%}) ({card})", flush=True)
        # where a frame's time goes: the host's time to enqueue a frame (no
        # sync), the time per frame with the device drained, and one traced
        # frame's device operations and busy time
        torch.cuda.synchronize()
        t_enqueue = time.perf_counter()
        for i in range(REALTIME_FRAMES):
            r.draw_frame_async(i / 60.0)
        enqueue_ms = (time.perf_counter() - t_enqueue) * 1e3 / REALTIME_FRAMES
        torch.cuda.synchronize()
        drained_ms = (time.perf_counter() - t_enqueue) * 1e3 / REALTIME_FRAMES
        realtime_ms[label] = (enqueue_ms, drained_ms)
        tr = bench.trace_frame(lambda i: r.draw_frame_async(0.5), dev)
        busy = "not measured" if tr["device_busy_ms"] is None else f"{tr['device_busy_ms']:.3f} ms"
        print(f"[chip_smoke] realtime {label} frame: host enqueue {enqueue_ms:.3f} ms, drained "
              f"{drained_ms:.3f} ms per frame ({REALTIME_FRAMES} frames); traced frame "
              f"{tr['frame_ms']:.3f} ms, {tr['device_ops']} device operations, device busy {busy} "
              f"({card})", flush=True)
    torch.cuda.synchronize()
    counts = {f"sphere_megakernel[{m}]": n for m, n in mk.LAUNCHES_BY_MODE.items()}
    counts.update({f"tape_kernel[{m}]": n for m, n in tk.LAUNCHES_BY_MODE.items()})
    counts.update({f"trimesh_kernel[{m}]": n for m, n in tm.LAUNCHES_BY_MODE.items()})
    print(f"[chip_smoke] main path took {time.perf_counter() - t0:.1f} s; launches {counts}; "
          f"sphere kernel tables {mk.LAUNCHES_BY_TABLES}; mesh kernel tables "
          f"{tm.LAUNCHES_BY_TABLES}", flush=True)
    if mk.LAUNCHES_BY_TABLES["shared"] == 0:
        fail("no sphere launch of the main path staged its tables in shared memory")
    if not all(tm.LAUNCHES_BY_TABLES.values()):  # meshnight stages, the bench mesh cannot
        fail(f"the mesh launches of the main path read their tables from {tm.LAUNCHES_BY_TABLES}")
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
                        "tape_kernel[audit]", "tape_kernel[audit-nee]",
                        "trimesh_kernel[grid]", "trimesh_kernel[grid-nee]") if counts[k] == 0]
    if idle:
        fail(f"kernel modes never launched on the main path: {idle}")

    # --- phase 4: the tools path, counts from zero
    exp_tools = {"exp_gather": exp_gather, "exp_slab": exp_slab, "exp_dot_k": exp_dot_k}
    for mod in (*exp_tools.values(), mk, tk, tm):
        mod.LAUNCHES = 0
        for k in mod.LAUNCHES_BY_MODE:
            mod.LAUNCHES_BY_MODE[k] = 0
    exp_dot_k.LAUNCHES_BY_RUN.clear()
    t0 = time.perf_counter()
    # each tool's main() holds every run to its plain version and the float64 formula (and
    # the paired modes to the bit) at n_iter 2,000, raising on a miss, then times its slope
    exp_rows = {name: tool.main(["--reps", str(EXP_REPS[name])])
                for name, tool in exp_tools.items()}
    rc = validate_gpu.main(["--only", "config1,config2"])
    tool_counts = {f"{name}[{m}]": n for name, tool in exp_tools.items()
                   for m, n in tool.LAUNCHES_BY_MODE.items()}
    tool_counts["sphere_megakernel[brute]"] = mk.LAUNCHES_BY_MODE["brute"]
    print(f"[chip_smoke] tools path took {time.perf_counter() - t0:.1f} s; launches {tool_counts}",
          flush=True)
    if rc != 0:
        fail("validate_gpu --only config1,config2 failed")
    idle = [k for k, n in tool_counts.items() if n == 0]
    if idle:
        fail(f"kernel modes never launched on the tools path: {idle}")

    # --- phase 5: the parallel path, counts from zero
    canary = phase5(card, result, mhz, dev)

    # --- phase 6: the realtime and denoise path, counts from zero
    denoise_entries = phase6(card, mhz, dev, realtime_ms["rtiow"])

    # --- phase 7: the demos, counts from zero
    phase7(card, dev, result)

    kernels = []
    for name in ("sphere_megakernel[grid]", "sphere_megakernel[brute]",
                 "sphere_megakernel[grid-nee]", "sphere_megakernel[brute-nee]",
                 "tape_kernel[clustered]", "tape_kernel[global]", "tape_kernel[clustered-nee]",
                 "tape_kernel[global-nee]", "tape_kernel[audit]", "tape_kernel[audit-nee]",
                 "trimesh_kernel[brute]", "trimesh_kernel[grid]",
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
    # the micro-experiments: one entry per mode (per combo and mode for exp_dot_k), each
    # checked, timed and bounded at n_iter 2,000 by its tool's main() on the tools path
    for tool, rows in exp_rows.items():
        source, replaces = KERNELS[tool]
        for row in rows:
            if tool == "exp_dot_k":
                run = (row["rr_pad"], row["pw"], row["k"], row["mode"])
                name = f"{tool}[{row['mode']} rr{run[0]} pw{run[1]} k{run[2]}]"
                launches = exp_dot_k.LAUNCHES_BY_RUN.get(run, 0)
            else:
                name = f"{tool}[{row['mode']}]"
                launches = exp_tools[tool].LAUNCHES_BY_MODE[row["mode"]]
            if launches == 0:
                fail(f"{name} never launched on the tools path")
            bound_ms, bound_by = exp_bound(tool, row["mode"], mhz, row["table_bytes"],
                                           row.get("rr_pad", 0), row.get("k", 0))
            print(f"[chip_smoke] {name} n_iter {EXP_N_ITER}: bound {bound_ms:.5f} ms "
                  f"({bound_by}); kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"slope {row['ns_per_iter']:.1f} ns/iteration ({card})", flush=True)
            kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                                launches=launches, max_abs_err=row["max_abs_err"],
                                ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=None,
                                slope_ns=row["ns_per_iter"]))
    kernels.append(canary)
    kernels.extend(denoise_entries)
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
