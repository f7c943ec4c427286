"""The benchmark's plain many-solids reference (``benchmark/reference/solids.py``,
which imports nothing of the port) against the port's plain tape path, on
the CPU, and the port's leaf-interval count.

On CPU tensors the port's tape path is the kernel's plain version
(``kernels/tape_kernel.py``), which the kernel repeats operation for
operation; the reference builds its own leaves from the configuration
file and evaluates them by the kernel's operations, so on the CPU the two
agree exactly:

- the configuration's object list builds, through ``SceneGraph``, the tape
  of ``models.many_objects_scene(99).compile(k=4)``, leaf for leaf, and
  the same clusters;
- on seeded random rays (some parallel to an axis, where the slabs, the
  half-space and the cylinder take their flat branches), the reference's
  sphere, box, cylinder and half-space intervals are the port's, bit for
  bit, and so are its surfaces (t, entering) and its attribution (normal,
  material);
- a frame through the reference's bounce loop is the port's progressive
  frame, and its segments are equal;
- the port's leaf-interval count of a frame is leaves x segments, in the
  event flip and the audit alike, shadow rays left out, and
  ``PathTraceRenderer`` reads it at its fence.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import camera, load_module  # noqa: E402
from benchmark.reference import core  # noqa: E402
from benchmark.reference.solids import Solids  # noqa: E402
from csgrenderer_tpu_torch.app import PathTraceRenderer  # noqa: E402
from csgrenderer_tpu_torch.camera import Camera  # noqa: E402
from csgrenderer_tpu_torch.kernels import tape_kernel as tk  # noqa: E402
from csgrenderer_tpu_torch.models import (  # noqa: E402
    csg_night_scene,
    many_objects_scene,
    mesh_demo_scene,
    two_spheres_scene,
)
from csgrenderer_tpu_torch.utils.config import RenderConfig  # noqa: E402

CONFIG = json.loads((REPO / "benchmark" / "configs" / "manyobjects99.json").read_text())
MODULE = load_module(REPO / "benchmark" / "configs" / "manyobjects99.py", "t_manyobjects99")
WIDTH, HEIGHT, SPP = 32, 18, 2
SEEDS = (5, 2**31 + 977)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cut(n_objects: int) -> dict:
    """The configuration with its first ``n_objects`` objects and the ground."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["scene"]["objects"] = cfg["scene"]["objects"][:n_objects]
    cfg["scene"]["leaves"] = 2 * n_objects + 1
    return cfg


@pytest.fixture(scope="module")
def whole():
    """(packed program tape, reference) of the whole 199-leaf scene."""
    tape, _ = MODULE.program_scene(CONFIG, "cpu", False, 0.0)
    return tk.pack_program(tape), Solids.build(CONFIG["scene"], torch.float32, "cpu")


def random_rays(n: int, seed: int):
    """Rays from over and among the solids in every direction; a tenth with
    a zero y component (parallel to the ground, the boxes' y slabs and the
    cylinders' caps) and a tenth along y (down the cylinders' axes)."""
    g = torch.Generator().manual_seed(seed % 2**31)
    o = torch.rand((n, 3), generator=g) * torch.tensor([28.0, 6.0, 28.0]) - torch.tensor(
        [14.0, 0.5, 14.0])
    d = torch.randn((n, 3), generator=g)
    k = n // 10
    d[:k, 1] = 0.0
    d[k:2 * k, 0] = 0.0
    d[k:2 * k, 2] = 0.0
    return o, d


def test_the_object_list_builds_the_programs_tape():
    tape, animate = MODULE.program_scene(CONFIG, "cpu", False, 0.0)
    want = many_objects_scene(99).compile(k=4)
    assert animate is None and tape.n_leaves == want.n_leaves == 199
    assert tape.ops == want.ops and tape.leaf_types == want.leaf_types and tape.k == want.k == 4
    mine, theirs = tk.pack_program(tape), tk.pack_program(want)
    for name in ("leaf_table", "leaf_types", "ops", "cluster_table", "leaf_ids", "list_ops"):
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name
    assert mine.clusters == theirs.clusters and len(mine.clusters) == 100
    assert max(len(leaves) for _, leaves in mine.clusters) == 2 and mine.interval_cap == 8
    assert MODULE.work(CONFIG) == {"leaves": 199, "objects": 99,
                                   "leaf_types": ["sphere", "halfspace", "box", "cylinder"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_intervals_are_the_ports(whole, seed):
    packed, ref = whole
    o, d = random_rays(20000, seed)
    enter, exit_ = tk._leaf_intervals(packed, o, d)
    r_enter, r_exit = ref.intervals(o, d)
    assert torch.equal(enter, r_enter) and torch.equal(exit_, r_exit)
    types = packed.tape.leaf_types
    for kind in set(types):  # every leaf type is hit by some ray
        cols = [i for i, t in enumerate(types) if t == kind]
        assert bool((enter[:, cols] <= exit_[:, cols]).any()), kind


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_surfaces_and_attribution_are_the_ports(whole, seed):
    packed, ref = whole
    o, d = random_rays(20000, seed + 1)
    t, entering = tk.tape_hit_events(packed, o, d)
    r_t, r_entering = ref.surface(o, d)
    hit = t < 5e8
    assert 0.3 < float(hit.float().mean()) < 0.9
    assert torch.equal(t, r_t) and torch.equal(entering[hit], r_entering[hit])
    h, r = tk.tape_hit(packed, o, d), ref.nearest_hit(o, d)
    assert torch.equal(h.hit, r.hit)
    for mine, theirs in ((h.normal, r.normal), (h.front_face, r.front_face),
                         (h.mat_kind, r.mat_kind), (h.albedo, r.albedo),
                         (h.mat_param, r.mat_param)):
        assert torch.equal(mine[hit].to(theirs.dtype), theirs[hit])
    owners = set(torch.argmin(tk._leaf_scores(packed, o + torch.where(hit, t, 1.0)[:, None] * d)[0],
                              dim=-1)[hit].tolist())
    assert {packed.tape.leaf_types[i] for i in owners} == set(packed.tape.leaf_types)


def program_frame(cfg: dict, seed: int):
    """(radiance, segments, leaf intervals) of the port's first progressive
    frame of ``cfg``'s scene."""
    tape, _ = MODULE.program_scene(cfg, "cpu", False, 0.0)
    cam = Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(cfg, {}))
    rc = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=cfg["bounces"],
                      seed=seed & 0xFFFFFFFF, sky=cfg["sky"], gamma=cfg["gamma"])
    r = PathTraceRenderer(tape, cam, rc, progressive=True, device="cpu")
    r.draw_frame(0.0)
    return r.accumulator.radiance_sum / SPP, r.last_frame_rays, r.last_frame_leaf_tests


@pytest.mark.parametrize("n_objects,seed", [(8, SEEDS[0]), (12, SEEDS[1])])
def test_a_frame_through_the_reference_is_the_programs(n_objects, seed):
    cfg = cut(n_objects)
    radiance, rays, tests = program_frame(cfg, seed)
    ref = Solids.build(cfg["scene"], torch.float32, "cpu")
    cam = core.Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(cfg, {}))
    img, ref_rays = core.render_rows(ref.nearest_hit, cam, WIDTH, HEIGHT, list(range(HEIGHT)),
                                     SPP, cfg["bounces"], seed & 0xFFFFFFFF, cfg["sky"], False,
                                     sample_offset=0)
    assert int(ref_rays) == rays > WIDTH * HEIGHT * SPP
    assert torch.equal(img, radiance)
    assert tests == (2 * n_objects + 1) * rays


@pytest.mark.parametrize("partition", ["auto", False])
@pytest.mark.parametrize("with_overflow", [False, True])
def test_the_leaf_tests_are_leaves_times_segments_without_the_shadow_rays(partition,
                                                                        with_overflow):
    tape = csg_night_scene().compile(k=4)
    packed = tk.pack_program(tape, partition)
    cam = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0, aspect_ratio=2.0)
    counts = {}
    out = tk.render_image_tape_kernel(packed, cam, 24, 12, spp=1, max_bounces=4, sky="black",
                                      nee=True, with_overflow=with_overflow, counts=counts)
    rays = out[1]
    assert int(counts["shadow_rays"]) > 0
    assert int(counts["leaf_tests"]) == int(rays) * tape.n_leaves


def test_the_renderer_reads_the_leaf_tests_and_other_scenes_read_none():
    _, rays, tests = program_frame(cut(4), 9)
    assert tests == 9 * rays > 0
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    frame = RenderConfig(width=16, height=8, spp=1, max_bounces=3)
    for scene in (two_spheres_scene(), mesh_demo_scene(1, spheres=2)):
        r = PathTraceRenderer(scene, cam, frame, progressive=True, device="cpu")
        r.draw_frame(0.0)
        assert r.last_frame_leaf_tests is None and r.last_frame_rays > 0
