"""The CUDA sphere, tape and triangle-mesh kernels against their plain
torch versions, on the card, without and with next-event estimation (NEE);
their row slabs against the full frame; the micro-experiment kernels
(kernel rows 6-8, ``csgrenderer_tpu_torch/tools/exp_*.py``) against their
plain versions; the sharded render over a one-rank mesh against the
kernels' frames; the shard canary (kernel row 9) against its plain
version; the a-trous filter's kernel against its plain version, on its
own (a ragged frame at 5 passes among them) and inside the renderer's
denoise step; the sphere kernel's NEE shadow-ray count against its plain
version's, and read by the renderer at its fence; the sphere kernel's
NEE frames pinned to their images, rays and shadow rays; its
G-buffer mode against its plain
version, on its own, with its tables in global memory and as the denoised
sphere frame's AOV cast; the random CSG trees of
tests/test_torch_tape_fuzz.py through the tape kernel; and the live
denoised frame replayed from a CUDA graph against the same frame enqueued
eagerly; and progressive frames with the next frame queued behind each
against the same frames rendered one at a time; the mesh kernel's
triangle-test count against its plain version's, read by the renderer at
its fence, its global-memory walk's count of the visits its occupancy
mask answered against the plain walk's, and the mesh-720p16 cell's
102,402-face mesh through the renderer from global memory; the tape
kernel's leaf-interval count against its plain version's (deepcsg and the
199-leaf many-objects scene), read by the renderer at its fence.

Needs an NVIDIA GPU with nvcc: every test here carries the ``cuda`` marker
and skips where ``torch.cuda.is_available()`` is false. The file imports
no JAX, so it also runs on a host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version repeat the same float operations, so they agree
far inside the bounds used against the JAX reference
(tests/test_kernels.py::compare): RMSE <= 2e-2, at most 1% of pixels off
by more than 0.05, rays within max(2e-3 * ref, 8).
"""

import hashlib

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.app import App, PathTraceRenderer, StatsClock, frame_graph, renderers
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import atrous, build
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import shard_canary as sc
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
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
from csgrenderer_tpu_torch.parallel import render_scene_sharded, single_device_mesh
from csgrenderer_tpu_torch.render import denoise, integrator, render_aovs
from csgrenderer_tpu_torch.render.trimesh import concat_meshes, icosphere, quad
from csgrenderer_tpu_torch.scene import Material
from csgrenderer_tpu_torch.tools import common, exp_dot_k, exp_gather, exp_slab
from csgrenderer_tpu_torch.utils import profiling
from csgrenderer_tpu_torch.utils.config import RenderConfig
from test_torch_tape_fuzz import SEEDS as FUZZ_SEEDS
from test_torch_tape_fuzz import port_tree as fuzz_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rtiow_camera(aspect, device):
    return Camera.look_at(
        (13, 2, 3), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=aspect,
        aperture=0.1, focus_dist=10.0, device=device,
    )


def _assert_close(ref, ref_rays, img, rays):
    ref, img = ref.cpu().numpy(), img.cpu().numpy()
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    frac_bad = float((np.abs(ref - img).max(axis=-1) > 0.05).mean())
    assert rmse <= 2e-2, rmse
    assert frac_bad <= 0.01, frac_bad
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)


CASES = {
    "two-spheres-brute": (lambda dev: two_spheres_scene(device=dev),
                          lambda dev: Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                                                     aspect_ratio=2.0, device=dev),
                          dict(width=64, height=32, spp=4, max_bounces=4, seed=5)),
    "rtiow-grid4-brute-lens": (lambda dev: rtiow_final_scene(grid=4, device=dev),
                               lambda dev: _rtiow_camera(2.0, dev),
                               dict(width=64, height=32, spp=4, max_bounces=6, seed=7, lens=True)),
    "rtiow-grid-lens": (lambda dev: rtiow_final_scene(device=dev),
                        lambda dev: _rtiow_camera(50 / 30, dev),
                        dict(width=50, height=30, spp=2, max_bounces=8, seed=3, lens=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    make_scene, make_cam, kw = CASES[case]
    packed = mk.pack_scene(make_scene(cuda))
    cam = make_cam(cuda)
    before = mk.LAUNCHES
    img, rays = mk.render_image_kernel(packed, cam, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    assert rays.dtype == torch.int64
    ref, ref_rays = mk.render_image_plain(packed, cam, **kw)
    _assert_close(ref, ref_rays, img, rays)


def test_grid_mode_matches_brute_mode(cuda):
    scene = rtiow_final_scene(device=cuda)
    cam = _rtiow_camera(2.0, cuda)
    kw = dict(width=64, height=32, spp=2, max_bounces=8, seed=11, lens=True)
    grid, grid_rays = mk.render_image_kernel(scene, cam, worklist=True, **kw)
    brute, brute_rays = mk.render_image_kernel(scene, cam, worklist=False, **kw)
    torch.cuda.synchronize()
    _assert_close(brute, brute_rays, grid, grid_rays)


def test_sample_offset_and_sky_modes(cuda):
    scene = two_spheres_scene(device=cuda)
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0, device=cuda)
    a, _ = mk.render_image_kernel(scene, cam, 32, 16, spp=1, max_bounces=3, seed=5)
    b, _ = mk.render_image_kernel(scene, cam, 32, 16, spp=1, max_bounces=3, seed=5, sample_offset=1)
    assert float((a - b).abs().max()) > 1e-4
    packed = mk.pack_scene(scene)
    for sky in ("wololo", "black"):
        img, rays = mk.render_image_kernel(packed, cam, 32, 16, spp=1, max_bounces=3, sky=sky)
        ref, ref_rays = mk.render_image_plain(packed, cam, 32, 16, spp=1, max_bounces=3, sky=sky)
        _assert_close(ref, ref_rays, img, rays)


def _deepcsg(dev):
    graph, animate = animated_csg_scene(8)
    return animate(graph.compile(k=4, device=dev), 1.0)


TAPE_CASES = {
    "config3-global": (lambda dev: config3_csg_scene().compile(device=dev), "auto", "global",
                       ((3, 2.5, 4), (0.1, 0, 0), 35.0), dict(width=64, height=64, spp=4, max_bounces=6,
                                                             seed=3)),
    "deepcsg-clustered": (_deepcsg, "auto", "clustered", ((0, 2.0, 7.0), (0.5, 0, 0), 40.0),
                          dict(width=96, height=54, spp=2, max_bounces=5, seed=5)),
    "deepcsg-global": (_deepcsg, False, "global", ((0, 2.0, 7.0), (0.5, 0, 0), 40.0),
                       dict(width=96, height=54, spp=2, max_bounces=5, seed=5)),
    "many-objects-clustered": (lambda dev: many_objects_scene(9).compile(k=4, device=dev), True,
                               "clustered", ((0, 7.0, 9.0), (0, 0.4, 0), 45.0),
                               dict(width=64, height=32, spp=2, max_bounces=8, seed=1)),
}


@pytest.mark.parametrize("case", sorted(TAPE_CASES))
def test_tape_kernel_matches_plain(cuda, case):
    make_tape, partition, mode, (eye, at, vfov), kw = TAPE_CASES[case]
    packed = tk.pack_program(make_tape(cuda), partition)
    assert packed.mode == mode
    cam = Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=kw["width"] / kw["height"],
                         device=cuda)
    before = dict(tk.LAUNCHES_BY_MODE)
    img, rays = tk.render_image_tape_kernel(packed, cam, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES_BY_MODE[mode] == before[mode] + 1
    assert rays.dtype == torch.int64
    ref, ref_rays = tk.render_image_tape_plain(packed, cam, **kw)
    _assert_close(ref, ref_rays, img, rays)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_tape_kernel_matches_plain_on_random_trees(cuda, seed):
    """The random CSG trees of tests/test_torch_tape_fuzz.py (random
    primitives under random rigid edges and random ops, normal-map
    materials) through the tape kernel at 64x64 against its plain version."""
    _, tape, _, _, _ = fuzz_tree(seed)
    packed = tk.pack_program(tape.to(cuda))
    cam = Camera.look_at((6.0, 4.0, 8.0), (0, 0, 0), vfov_degrees=50.0, aspect_ratio=1.0,
                         device=cuda)
    kw = dict(width=64, height=64, spp=4, max_bounces=4, seed=seed)
    before = tk.LAUNCHES
    img, rays = tk.render_image_tape_kernel(packed, cam, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    ref, ref_rays = tk.render_image_tape_plain(packed, cam, **kw)
    _assert_close(ref, ref_rays, img, rays)


def _night_cam(dev):
    return Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0, aspect_ratio=2.0,
                          device=dev)


def _csg_night_cam(dev):
    return Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0, aspect_ratio=2.0,
                          device=dev)


NEE_KW = dict(width=64, height=32, spp=2, max_bounces=6, seed=2, sky="black", nee=True)
NEE_CASES = {
    "brute-nee": (lambda dev: mk.pack_scene(night_scene(device=dev)), _night_cam, mk),
    "grid-nee": (lambda dev: mk.pack_scene(night_scene(grid=11, device=dev)), _night_cam, mk),
    "clustered-nee": (lambda dev: tk.pack_program(csg_night_scene().compile(k=4, device=dev)),
                      _csg_night_cam, tk),
}


@pytest.mark.parametrize("mode", sorted(NEE_CASES))
def test_nee_kernel_matches_plain(cuda, mode):
    make_packed, make_cam, mod = NEE_CASES[mode]
    packed, cam = make_packed(cuda), make_cam(cuda)
    assert packed.mode + "-nee" == mode
    kernel, plain = ((mk.render_image_kernel, mk.render_image_plain) if mod is mk else
                     (tk.render_image_tape_kernel, tk.render_image_tape_plain))
    before = mod.LAUNCHES_BY_MODE[mode]
    img, rays = kernel(packed, cam, **NEE_KW)
    torch.cuda.synchronize()
    assert mod.LAUNCHES_BY_MODE[mode] == before + 1
    ref, ref_rays = plain(packed, cam, **NEE_KW)
    _assert_close(ref, ref_rays, img, rays)
    assert float(img.max()) > 0.0  # the lamps light the scene


# sha256 of the float32 image bytes and the ray count of fixed frames, as
# the kernels before their NEE variants (without kNee) rendered them on an
# H100: the non-NEE instantiations must keep giving these images
PINNED_FRAMES = {
    "grid": ("e31d4b06dfd1e0ff47c6acf1f2b8ba29a1f7ed308107b319651353a3516fb705", 10341),
    "brute": ("be7366d32229b6443cfbb6cb2febaee8762da60b776c5502e212be2fea93959f", 14131),
    "clustered": ("7b5bb309e62deeee268a93f35a1bd86f4c4a9721de080b49f90dd7a312d1a3fb", 11433),
    "global": ("fc227142930be0ab419bee738440ac985caec83f69f9e166fb618d7b8205b7eb", 24599),
}


def _pinned_case(mode, dev):
    if mode == "grid":
        return (mk.render_image_kernel, rtiow_final_scene(device=dev), _rtiow_camera(2.0, dev),
                dict(width=64, height=32, spp=2, max_bounces=8, seed=11, lens=True))
    if mode == "brute":
        return (mk.render_image_kernel, two_spheres_scene(device=dev),
                Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0,
                               device=dev),
                dict(width=64, height=32, spp=4, max_bounces=4, seed=5))
    if mode == "clustered":
        return (tk.render_image_tape_kernel, _deepcsg(dev),
                Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                               aspect_ratio=96 / 54, device=dev),
                dict(width=96, height=54, spp=2, max_bounces=5, seed=5))
    return (tk.render_image_tape_kernel, config3_csg_scene().compile(device=dev),
            Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=1.0,
                           device=dev),
            dict(width=64, height=64, spp=4, max_bounces=6, seed=3))


@pytest.mark.parametrize("mode", sorted(PINNED_FRAMES))
def test_non_nee_frames_unchanged(cuda, mode):
    render, scene, cam, kw = _pinned_case(mode, cuda)
    img, rays = render(scene, cam, **kw)
    torch.cuda.synchronize()
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == PINNED_FRAMES[mode]


# sha256 of the float32 image bytes, the ray count and the shadow-ray count
# of NEE_CASES' sphere frames, as the NEE kernels that traced a shadow ray
# inside the segment that made it rendered them on an H100: the query loop
# that traces both kinds of ray through one walk must keep giving these
PINNED_NEE_FRAMES = {
    "brute-nee": ("86105de6d4754db1fdf50bcebf31f7c0a0f18a89afdff10239b97ae2b84e77ac", 8484, 3049),
    "grid-nee": ("e4023dade312cb4c608a541d25b69cbc46b17823b183401e1f8b1e96076955c8", 8745, 3040),
}


@pytest.mark.parametrize("mode", sorted(PINNED_NEE_FRAMES))
def test_nee_frames_unchanged(cuda, mode):
    make_packed, make_cam, _ = NEE_CASES[mode]
    counts = {}
    img, rays = mk.render_image_kernel(make_packed(cuda), make_cam(cuda), counts=counts, **NEE_KW)
    torch.cuda.synchronize()
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays), int(counts["shadow_rays"])) == PINNED_NEE_FRAMES[mode]


# sha256 of the float32 image bytes, the ray count and (audit) the
# dropped-span count of the mesh kernel's four modes and the tape kernel's
# NEE and audit modes at small frames, as the kernels before their
# persistent-CTA redesign rendered them on an H100: every later design of
# these kernels must keep giving these images
PINNED_MESH_TAPE_FRAMES = {
    "mesh-brute": ("4b2fa4ea3323ced81f7d3625e3483da2980d69d090d6a67c666141f3a7734fba", 7429),
    "mesh-grid": ("96086beda1db2854b865d54c6f7f49188264d482fe4d403e4deb8b88da5dee93", 7425),
    "mesh-brute-nee": ("31528be7f48693988d3876b7474fd8aeae8bde6379b17e84ad5a6ea3d5f7af50", 4293),
    "mesh-grid-nee": ("bb21d06fccf74451cb8ba98b2b91578c5fba95c8b2e1bdb65290fa6fd540bf9d", 7150),
    "tape-clustered-nee": ("95ad45b4d23235ac80bfb65a976dfb0da4cf7cad4c3a691c4669aff7a8d1b047", 9080),
    "tape-global-nee": ("95ad45b4d23235ac80bfb65a976dfb0da4cf7cad4c3a691c4669aff7a8d1b047", 9080),
    "tape-audit": ("c247a08cc29a0c57b9ad45b7efc1b1115f07ca23095b7dad8fd80ec8e785c60c", 4733, 59),
    "tape-audit-nee": ("95ad45b4d23235ac80bfb65a976dfb0da4cf7cad4c3a691c4669aff7a8d1b047", 9080, 64),
}


def _pinned_mesh_tape_frame(name, dev):
    """(sha256 of the image bytes, rays[, dropped spans]) of frame ``name``."""
    if name.startswith("mesh-"):
        make_packed, eye, extra = MESH_CASES[name[len("mesh-"):]]
        out = tm.render_image_mesh_kernel(make_packed(dev), _mesh_cam(eye, dev), **MESH_KW,
                                          **extra)
    elif name == "tape-audit":
        make_packed, make_cam, kw, _ = AUDIT_CASES["pearls-k2-bounces"]
        out = tk.render_image_tape_kernel(make_packed(dev), make_cam(dev), with_overflow=True,
                                          **kw)
    else:
        k, partition = (2, "auto") if name == "tape-audit-nee" else (
            4, "auto" if name == "tape-clustered-nee" else False)
        tape = csg_night_scene().compile(k=k, device=dev)
        out = tk.render_image_tape_kernel(tk.pack_program(tape, partition), _csg_night_cam(dev),
                                          with_overflow=name == "tape-audit-nee", **NEE_KW)
    torch.cuda.synchronize()
    return (hashlib.sha256(out[0].cpu().numpy().tobytes()).hexdigest(),
            *(int(x) for x in out[1:]))


@pytest.mark.parametrize("name", sorted(PINNED_MESH_TAPE_FRAMES))
def test_mesh_and_tape_frames_unchanged(cuda, name):
    assert _pinned_mesh_tape_frame(name, cuda) == PINNED_MESH_TAPE_FRAMES[name]


def _mesh_cam(eye, dev):
    return Camera.look_at(eye, (0.0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=2.0, device=dev)


def _lamp_over_sphere(dev):
    """tests/test_nee.py's brute-path mesh NEE scene: 82 faces, two lamps."""
    return concat_meshes(
        icosphere((0, 0.7, -3), 0.7, Material.lambertian((0.6, 0.3, 0.3)), 1, dev),
        quad((-0.6, 2.2, -3.4), (0.6, 2.2, -3.4), (0.6, 2.2, -2.4), (-0.6, 2.2, -2.4),
             Material.emissive((12.0, 10.0, 8.0)), dev),
    )


MESH_KW = dict(width=64, height=32, spp=2, max_bounces=6, seed=2)
MESH_CASES = {
    "brute": (lambda dev: tm.pack_mesh(mesh_demo_scene(1, device=dev), False), (0.0, 1.6, 2.2),
              {}),
    "grid": (lambda dev: tm.pack_mesh(mesh_demo_scene(3, device=dev)), (0.0, 1.6, 2.2), {}),
    "brute-nee": (lambda dev: tm.pack_mesh(_lamp_over_sphere(dev)), (0, 1.4, 1.6),
                  dict(sky="black", nee=True)),
    "grid-nee": (lambda dev: tm.pack_mesh(mesh_night_scene(device=dev)), (0, 1.8, 2.4),
                 dict(sky="black", nee=True)),
}


@pytest.mark.parametrize("mode", sorted(MESH_CASES))
def test_mesh_kernel_matches_plain(cuda, mode):
    make_packed, eye, extra = MESH_CASES[mode]
    packed, cam = make_packed(cuda), _mesh_cam(eye, cuda)
    assert packed.mode + ("-nee" if extra else "") == mode
    before = tm.LAUNCHES_BY_MODE[mode]
    img, rays = tm.render_image_mesh_kernel(packed, cam, **MESH_KW, **extra)
    torch.cuda.synchronize()
    assert tm.LAUNCHES_BY_MODE[mode] == before + 1
    assert rays.dtype == torch.int64
    ref, ref_rays = tm.render_image_mesh_plain(packed, cam, **MESH_KW, **extra)
    _assert_close(ref, ref_rays, img, rays)
    assert float(img.max()) > 0.0


def _pearls(k, dev):
    """tests/test_interval_overflow.py's three disjoint spheres along +z."""
    from csgrenderer_tpu_torch.scene import NodeArgument, SceneGraph

    g = SceneGraph()
    s1, s2, s3 = (g.add_sphere_node(0.4, Material.lambertian(c))
                  for c in ((0.8, 0.2, 0.2), (0.2, 0.8, 0.2), (0.2, 0.2, 0.8)))
    u = g.add_union_of_node(NodeArgument(s1, offset=(0, 0, 2.0)), NodeArgument(s2, offset=(0, 0, 4.0)))
    g.add_union_of_node(NodeArgument(u), NodeArgument(s3, offset=(0, 0, 6.0)))
    return g.compile(k=k, device=dev)


AUDIT_CASES = {
    # (packed tape, camera, frame, whether the dropped-span count must be exact)
    "pearls-k2-primary": (lambda dev: tk.pack_program(_pearls(2, dev)),
                          lambda dev: Camera.look_at((0, 0, -6), (0, 0, 1), vfov_degrees=30.0,
                                                     aspect_ratio=1.0, device=dev),
                          dict(width=48, height=48, spp=1, max_bounces=1, seed=0), True),
    "pearls-k2-bounces": (lambda dev: tk.pack_program(_pearls(2, dev)),
                          lambda dev: Camera.look_at((0, 0, -6), (0, 0, 1), vfov_degrees=30.0,
                                                     aspect_ratio=1.0, device=dev),
                          dict(width=48, height=48, spp=2, max_bounces=3, seed=3), False),
    "csgnight-k2-nee": (lambda dev: tk.pack_program(csg_night_scene().compile(k=2, device=dev)),
                        _csg_night_cam, NEE_KW, False),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_kernel_matches_plain(cuda, case):
    """The interval-list audit mode against its plain version: image and
    rays within the compare bounds, the dropped-span count equal on primary
    rays and within the rays' bound over bounces (a silhouette flip changes
    which segments exist)."""
    make_packed, make_cam, kw, exact = AUDIT_CASES[case]
    packed, cam = make_packed(cuda), make_cam(cuda)
    mode = "audit-nee" if kw.get("nee") else "audit"
    before = tk.LAUNCHES_BY_MODE[mode]
    img, rays, over = tk.render_image_tape_kernel(packed, cam, with_overflow=True, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES_BY_MODE[mode] == before + 1
    assert over.dtype == torch.int64 and int(over) > 0  # k = 2 drops spans here
    ref, ref_rays, ref_over = tk.render_image_tape_plain(packed, cam, with_overflow=True, **kw)
    _assert_close(ref, ref_rays, img, rays)
    allowed = 0 if exact else max(2e-3 * int(ref_over), 8)
    assert abs(int(over) - int(ref_over)) <= allowed


@pytest.mark.parametrize("mode", ["clustered", "global"])
def test_audit_frames_pinned(cuda, mode):
    """Away from overflow the audit's lists give the event flip's surfaces:
    the pinned event-flip frames, rendered by the audit mode, hash the same
    and drop no span."""
    render, scene, cam, kw = _pinned_case(mode, cuda)
    img, rays, over = render(scene, cam, with_overflow=True, **kw)
    torch.cuda.synchronize()
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays), int(over)) == PINNED_FRAMES[mode] + (0,)


# --- row slabs (rows=, row_offset=): the full frame's rows, bit for bit -------

SLAB_CASES = {
    "sphere-grid": (mk.render_image_kernel,
                    lambda dev: mk.pack_scene(rtiow_final_scene(device=dev)),
                    lambda dev: _rtiow_camera(2.0, dev),
                    dict(width=64, height=32, spp=2, max_bounces=6, seed=3, lens=True)),
    "tape-clustered": (tk.render_image_tape_kernel,
                       lambda dev: tk.pack_program(csg_night_scene().compile(k=4, device=dev)),
                       lambda dev: Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3),
                                                  vfov_degrees=38.0, aspect_ratio=2.0,
                                                  device=dev),
                       dict(width=64, height=32, spp=2, max_bounces=6, seed=1, sky="black",
                            nee=True)),
    "mesh-grid": (tm.render_image_mesh_kernel,
                  lambda dev: tm.pack_mesh(mesh_demo_scene(2, device=dev)),
                  lambda dev: Camera.look_at((0.0, 1.6, 2.2), (0.0, 0.7, -2.6),
                                             vfov_degrees=45.0, aspect_ratio=2.0, device=dev),
                  dict(width=64, height=32, spp=2, max_bounces=6, seed=2)),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_row_slabs_equal_the_frame(cuda, case):
    """Three slabs (rows 0-4, 5-22, 23-31) of each kernel equal the full
    kernel frame's rows bit for bit, and their rays sum to the frame's."""
    kernel, make, camera, kw = SLAB_CASES[case]
    packed, cam = make(cuda), camera(cuda)
    full, rays = kernel(packed, cam, **kw)
    got, got_rays = [], 0
    for offset, rows in ((0, 5), (5, 18), (23, 9)):
        img, r = kernel(packed, cam, rows=rows, row_offset=offset, **kw)
        assert img.shape == (rows, kw["width"], 3)
        got.append(img)
        got_rays += int(r)
    assert torch.equal(torch.cat(got), full)
    assert got_rays == int(rays)


# --- kernel rows 6-8: the micro-experiments ------------------------------------

N_EXP = 64  # loop length of the card tests


def _exp_runs(dev):
    """(tool, mode, kernel(n_iter), plain(n_iter), formula(n_iter)) per
    mode (per combo and mode for exp_dot_k), on the tools' own inputs;
    formula gives (float64 result, sum|terms|)."""
    cpu = lambda t: t.float().cpu().numpy()  # noqa: E731
    tab, idx = exp_gather.make_inputs(dev)
    runs = [(exp_gather, m, lambda n, m=m: exp_gather.gather(tab, idx, m, n),
             lambda n, m=m: exp_gather.gather_plain(tab, idx, m, n),
             lambda n: exp_gather.gather_numpy(cpu(tab), cpu(idx), n)) for m in exp_gather.MODES]
    lane, sub, sidx = exp_slab.make_inputs(dev)
    for m in exp_slab.MODES:
        t = lane if m == "lane" else sub
        runs.append((exp_slab, m, lambda n, m=m, t=t: exp_slab.slab(t, sidx, m, n),
                     lambda n, m=m, t=t: exp_slab.slab_plain(t, sidx, m, n),
                     lambda n, m=m, t=t: exp_slab.slab_numpy(cpu(t), cpu(sidx), m, n)))
    didx, tabs = exp_dot_k.make_inputs(dev)
    for (rr, pw, k, m), t in tabs:  # every combo of the tool, so every kernel shape
        a = (t, didx, rr, pw, k, m)
        runs.append((exp_dot_k, m, lambda n, a=a: exp_dot_k.dot_k(*a, n),
                     lambda n, a=a: exp_dot_k.dot_k_plain(*a, n),
                     lambda n, a=a: exp_dot_k.dot_k_numpy(cpu(a[0]), cpu(a[1]), *a[2:], n)))
    return runs


def test_exp_kernels_match_plain(cuda):
    """Every mode of rows 6-8 against its plain version on the same inputs
    and against the float64 formula, within 1e-6 * sum|terms|."""
    for tool, mode, run, plain, formula in _exp_runs(cuda):
        before = tool.LAUNCHES_BY_MODE[mode]
        got = run(N_EXP)
        torch.cuda.synchronize()
        assert tool.LAUNCHES_BY_MODE[mode] == before + 1
        ref, terms = formula(N_EXP)
        for other in (plain(N_EXP).cpu().numpy(), ref):
            err, ratio = common.agreement(got.cpu().numpy(), other, terms)
            assert ratio <= 1.0, (tool.__name__, mode, err)


def test_exp_paired_modes_equal_bitwise(cuda):
    """onehot = shuffle (row 8), lane = sublane and loopscalar =
    carryscalar (row 7), to the bit."""
    tab, idx = exp_gather.make_inputs(cuda)
    assert torch.equal(exp_gather.gather(tab, idx, "onehot", N_EXP),
                       exp_gather.gather(tab, idx, "shuffle", N_EXP))
    lane, sub, sidx = exp_slab.make_inputs(cuda)
    assert torch.equal(exp_slab.slab(lane, sidx, "lane", N_EXP),
                       exp_slab.slab(sub, sidx, "sublane", N_EXP))
    assert torch.equal(exp_slab.slab(sub, sidx, "loopscalar", N_EXP),
                       exp_slab.slab(sub, sidx, "carryscalar", N_EXP))


# --- the multi-device path on one card, and kernel row 9 (the shard canary) -----


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_single_device_mesh_equals_the_kernel(cuda, case):
    """render_scene_sharded over single_device_mesh() is the unsharded
    kernel frame bit for bit, rays equal, for each of the three kernels."""
    kernel, make, camera, kw = SLAB_CASES[case]
    packed, cam = make(cuda), camera(cuda)
    full, rays = kernel(packed, cam, **kw)
    frame = {k: v for k, v in kw.items() if k not in ("width", "height")}
    img, got_rays = render_scene_sharded(packed, cam, kw["width"], kw["height"],
                                         single_device_mesh(), **frame)
    assert torch.equal(img, full) and int(got_rays) == int(rays)


def test_canary_kernel_matches_plain(cuda):
    """scale2_kernel launches csrc/shard_canary.cu once and equals
    scale2_plain and torch.mul(x, 2.0) bit for bit; a wrong shape raises."""
    x = torch.arange(1024, dtype=torch.float32, device=cuda).reshape(sc.SHAPE) * 0.37 - 11.0
    before = sc.LAUNCHES
    out = sc.scale2_kernel(x)
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + 1
    assert torch.equal(out, sc.scale2_plain(x)) and torch.equal(out, torch.mul(x, 2.0))
    with pytest.raises(ValueError, match="shape"):
        sc.scale2_kernel(x[:, :64].contiguous())


@pytest.mark.parametrize("worklist", ["auto", False])
def test_shared_and_global_tables_give_the_same_bytes(cuda, worklist):
    """The sphere kernel with its tables staged in shared memory (the size
    rule's choice for RTIOW) and with them read from global memory (forced
    through the launcher's test-only argument) renders the same bytes, in
    grid mode and forced brute mode."""
    packed = mk.pack_scene(rtiow_final_scene(device=cuda), worklist)
    assert packed.table_bytes <= mk.table_limit(cuda.index or 0)
    cam = mk.pack_camera(_rtiow_camera(2.0, cuda)).contiguous()
    args = (packed, cam, 64, 32, 2, 8, 11, 0, True, "rtiow", False)
    before = dict(mk.LAUNCHES_BY_TABLES)
    shared, shared_rays = mk._launch(*args)
    staged_global, global_rays = mk._launch(*args, force_global=True)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_TABLES == {"shared": before["shared"] + 1,
                                     "global": before["global"] + 1}
    assert torch.equal(shared, staged_global) and int(shared_rays) == int(global_rays)


def test_tables_over_the_limit_read_from_global_memory(cuda):
    """rtiow_final_scene(grid=40) (6,402 spheres, a 32 x 32 grid, 237,632
    table bytes) exceeds a block's opt-in shared memory: the launcher picks
    the global-memory tables by size, and the frame matches its plain
    version."""
    packed = mk.pack_scene(rtiow_final_scene(grid=40, device=cuda))
    assert packed.mode == "grid" and packed.table_bytes > mk.table_limit(cuda.index or 0)
    cam = _rtiow_camera(2.0, cuda)
    kw = dict(width=48, height=24, spp=2, max_bounces=8, seed=3, lens=True)
    before = dict(mk.LAUNCHES_BY_TABLES)
    img, rays = mk.render_image_kernel(packed, cam, **kw)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_TABLES["global"] == before["global"] + 1
    assert mk.LAUNCHES_BY_TABLES["shared"] == before["shared"]
    ref, ref_rays = mk.render_image_plain(packed, cam, **kw)
    _assert_close(ref, ref_rays, img, rays)


def test_grid_nee_matches_plain_with_equal_rays(cuda):
    """night488 in grid-nee mode at 64x32: within compare()'s bounds of its
    plain version, and the same number of path segments."""
    packed = mk.pack_scene(night_scene(grid=11, device=cuda))
    cam = _night_cam(cuda)
    assert packed.mode == "grid"
    img, rays = mk.render_image_kernel(packed, cam, **NEE_KW)
    torch.cuda.synchronize()
    ref, ref_rays = mk.render_image_plain(packed, cam, **NEE_KW)
    _assert_close(ref, ref_rays, img, rays)
    assert int(rays) == int(ref_rays)


@pytest.mark.parametrize("mode", ["brute-nee", "grid-nee"])
def test_nee_kernel_counts_the_plain_versions_shadow_rays(cuda, mode):
    """The NEE kernel's shadow rays, handed back in a device word without a
    wait, are the plain version's count on a small frame, within the bound
    ``_assert_close`` holds the segments to, and stay out of the segments;
    a launch without NEE counts none. The bound, not equality: kernel and
    plain version on the card take a lamp sample through the same
    operations, but not every one of them rounds alike (the kernel's
    ``1 / sqrtf``, ``cosf`` and ``sinf`` against torch's CUDA functions), so
    a sample on the edge of its lobe or its lamp can go either way: 3,040
    against 3,038 shadow rays on this grid-NEE frame, whose segments agree
    exactly, and 775,862 against 775,804 at 960x540."""
    make_packed, make_cam, _ = NEE_CASES[mode]
    packed, cam = make_packed(cuda), make_cam(cuda)
    mk.render_image_kernel(packed, cam, **NEE_KW)  # built and bound: the next launch only enqueues
    counts, plain = {}, {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, rays = mk.render_image_kernel(packed, cam, counts=counts, **NEE_KW)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, plain_rays = mk.render_image_plain(packed, cam, counts=plain, **NEE_KW)
    shadow, want = counts["shadow_rays"], int(plain["shadow_rays"])
    assert shadow.dtype == torch.int64 and shadow.device.type == "cuda"
    assert want > 0 and abs(int(shadow) - want) <= max(want * 2e-3, 8)
    assert int(rays) == int(plain_rays)
    none = {}
    mk.render_image_kernel(packed, cam, counts=none, **{**NEE_KW, "nee": False})
    assert none == {}


def test_the_renderer_reads_the_shadow_rays_at_its_fence(cuda):
    """``PathTraceRenderer.last_frame_shadow_rays`` of a progressive NEE
    frame is the kernel's count of that frame, read at the fence with its
    segments; 0 without NEE."""
    scene, cam = night_scene(grid=11, device=cuda), _night_cam(cuda)
    frame = {k: v for k, v in NEE_KW.items() if k != "nee"}
    for nee in (True, False):
        r = PathTraceRenderer(scene, cam, RenderConfig(**frame, nee=nee), progressive=True,
                              device=cuda)
        r.draw_frame(0.0)
        counts = {}
        _, rays = mk.render_image_kernel(r._packed, cam, counts=counts, **frame, nee=nee)
        assert r.last_frame_rays == int(rays)
        assert r.last_frame_shadow_rays == (int(counts["shadow_rays"]) if nee else 0)


@pytest.mark.parametrize("mode", ["grid-nee", "brute"])
def test_mesh_shared_and_global_tables_give_the_same_bytes(cuda, mode):
    """The mesh kernel with its tables staged in shared memory (the size
    rule's choice for meshnight and the 242-face brute mesh) and with
    them read from global memory (forced through the launcher's test-only
    argument) renders the same bytes and rays."""
    make_packed, eye, extra = MESH_CASES[mode]
    packed = make_packed(cuda)
    assert packed.table_bytes <= tm.table_limit(cuda.index or 0)
    cam = mk.pack_camera(_mesh_cam(eye, cuda)).contiguous()
    args = (packed, cam, 64, 32, 2, 6, 2, 0, False, extra.get("sky", "rtiow"),
            extra.get("nee", False))
    before = dict(tm.LAUNCHES_BY_TABLES)
    shared, shared_rays = tm._launch(*args)
    staged_global, global_rays = tm._launch(*args, force_global=True)
    torch.cuda.synchronize()
    assert tm.LAUNCHES_BY_TABLES == {"shared": before["shared"] + 1,
                                     "global": before["global"] + 1}
    assert torch.equal(shared, staged_global) and int(shared_rays) == int(global_rays)


@pytest.mark.parametrize("mode", ["grid", "grid-nee"])
def test_mesh_global_walk_counts_the_plain_versions_masked_visits(cuda, mode):
    """The global-memory walk (forced) answers from the grid's occupancy
    mask the voxel visits the plain walk counts as masked, on its path
    segments; it tests the plain version's faces, renders its pinned
    frame and matches the plain version's image. The grid mesh's 278,112
    bytes of tables go to global memory by size anyway; meshnight's are
    staged by size, and its staged walk, which has no mask, counts no
    masked visit. Neither grid (f = 1) has a coarse level: no walk of
    either skips."""
    make_packed, eye, extra = MESH_CASES[mode]
    packed = make_packed(cuda)
    cam = mk.pack_camera(_mesh_cam(eye, cuda)).contiguous()
    args = (packed, cam, 64, 32, 2, 6, 2, 0, False, extra.get("sky", "rtiow"),
            extra.get("nee", False))
    counts, by_size, plain = {}, {}, {}
    img, rays = tm._launch(*args, force_global=True, counts=counts)
    tm._launch(*args, counts=by_size)
    torch.cuda.synchronize()
    ref, ref_rays = tm.render_image_mesh_plain(packed, _mesh_cam(eye, cuda), counts=plain,
                                               **MESH_KW, **extra)
    assert int(counts["tri_tests"]) == int(by_size["tri_tests"]) == int(plain["tri_tests"])
    assert int(counts["masked_visits"]) == int(plain["masked_visits"]) > 0
    assert packed.grid.static.coarse_block == 0
    assert int(counts["coarse_skips"]) == int(by_size["coarse_skips"]) == 0
    staged = packed.table_bytes <= tm.table_limit(cuda.index or 0)
    assert staged == (mode == "grid-nee")
    assert int(by_size["masked_visits"]) == (0 if staged else int(counts["masked_visits"]))
    _assert_close(ref, ref_rays, img, rays)
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == PINNED_MESH_TAPE_FRAMES["mesh-" + mode]


def test_mesh_over_the_limit_reads_global_memory(cuda):
    """mesh_demo_scene(4) (15,362 faces, 1,251,952 table bytes) exceeds a
    block's opt-in shared memory: the launcher picks global memory by size,
    and the frame matches its plain version."""
    packed = tm.pack_mesh(mesh_demo_scene(4, device=cuda))
    assert packed.mode == "grid" and packed.table_bytes > tm.table_limit(cuda.index or 0)
    cam = _mesh_cam((0.0, 1.6, 2.2), cuda)
    before = dict(tm.LAUNCHES_BY_TABLES)
    img, rays = tm.render_image_mesh_kernel(packed, cam, **MESH_KW)
    torch.cuda.synchronize()
    assert tm.LAUNCHES_BY_TABLES == {"shared": before["shared"], "global": before["global"] + 1}
    ref, ref_rays = tm.render_image_mesh_plain(packed, cam, **MESH_KW)
    _assert_close(ref, ref_rays, img, rays)


@pytest.mark.parametrize("mode", sorted(MESH_CASES))
def test_mesh_kernel_counts_the_plain_versions_triangle_tests(cuda, mode):
    """The mesh kernel's triangle tests of its path segments, handed back
    in a device word without a wait, are the plain version's on a small
    frame (its walk's ``global_tests + face_tests`` of the path segments,
    or faces x segments in brute mode; shadow rays' tests in neither), and
    counting leaves the frame's image and segments bit for bit the pinned
    ones, made before the kernel counted."""
    make_packed, eye, extra = MESH_CASES[mode]
    packed, cam = make_packed(cuda), _mesh_cam(eye, cuda)
    tm.render_image_mesh_kernel(packed, cam, **MESH_KW, **extra)  # built and bound
    counts, plain = {}, {}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, rays = tm.render_image_mesh_kernel(packed, cam, counts=counts, **MESH_KW, **extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tests = counts["tri_tests"]
    assert tests.dtype == torch.int64 and tests.device.type == "cuda"
    _, plain_rays = tm.render_image_mesh_plain(packed, cam, counts=plain, **MESH_KW, **extra)
    assert int(rays) == int(plain_rays)
    assert int(tests) == int(plain["tri_tests"]) > 0
    if packed.mode == "brute":
        assert int(tests) == int(rays) * packed.mesh.num_faces
    else:
        path = int(plain["tri_tests"])
        walked = int(plain["global_tests"]) + int(plain["face_tests"])
        assert path == walked if not extra else path < walked
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == PINNED_MESH_TAPE_FRAMES["mesh-" + mode]


def test_the_renderer_reads_the_triangle_tests_at_its_fence(cuda):
    """``PathTraceRenderer.last_frame_tri_tests`` of a progressive mesh
    frame, queued behind the one before, is the kernel's count of that
    frame, read at the fence with its segments, as are
    ``last_frame_masked_visits`` and ``last_frame_coarse_skips`` (its
    278,112 bytes of tables are read from global memory; its grid, f = 1,
    has no coarse level, so its walk skips nothing); a sphere frame has
    none of them."""
    scene = mesh_demo_scene(3, device=cuda)
    cam = _mesh_cam((0.0, 1.6, 2.2), cuda)
    frame = dict(width=64, height=32, spp=2, max_bounces=6, seed=2)
    r = PathTraceRenderer(scene, cam, RenderConfig(**frame), progressive=True, device=cuda)
    assert r._schedule == "queue"
    for k in range(3):
        r.draw_frame(0.0)
        counts = {}
        _, rays = tm.render_image_mesh_kernel(r._packed, cam, counts=counts,
                                              sample_offset=k * frame["spp"], **frame)
        assert r.last_frame_rays == int(rays)
        assert r.last_frame_tri_tests == int(counts["tri_tests"]) > 2 * int(rays)
        assert r.last_frame_masked_visits == int(counts["masked_visits"]) > 0
        assert r.last_frame_coarse_skips == int(counts["coarse_skips"]) == 0
    s = PathTraceRenderer(two_spheres_scene(device=cuda), cam, RenderConfig(**frame),
                          progressive=True, device=cuda)
    s.draw_frame(0.0)
    assert s.last_frame_tri_tests is None and s.last_frame_shadow_rays == 0
    assert s.last_frame_masked_visits is None and s.last_frame_coarse_skips is None


def test_the_102k_face_mesh_renders_through_the_renderer_from_global_tables(cuda):
    """mesh_demo_scene(5, 5), the mesh-720p16 cell's 102,402 faces: its
    19,925,808 bytes of tables (a 257 x 67 x 193 grid, two global faces) go
    to global memory, and the renderer's progressive frames (queued) match
    the plain version's at a small frame; the triangle tests, the visits
    the occupancy mask (2 x 2 x 2 voxel blocks) answered and the coarse
    skips (8 x 8 x 8 voxel blocks), read at the fence, are the kernel's and
    within 2e-3 of the plain version's."""
    scene = mesh_demo_scene(5, spheres=5, device=cuda)
    cam = _mesh_cam((0.0, 1.6, 2.2), cuda)
    frame = dict(width=128, height=64, spp=2, max_bounces=6, seed=2**31 + 11)
    r = PathTraceRenderer(scene, cam, RenderConfig(**frame), progressive=True, device=cuda)
    packed = r._packed
    assert scene.num_faces == 102402 and packed.table_bytes == 19925808
    assert packed.grid.static.dims == (257, 67, 193) and packed.grid.n_globals == 2
    assert packed.grid.static.mask_block == 2 and packed.grid.static.coarse_block == 8
    before = dict(tm.LAUNCHES_BY_TABLES)
    r.draw_frame(0.0)
    r.draw_frame(0.0)
    torch.cuda.synchronize()
    assert tm.LAUNCHES_BY_TABLES["shared"] == before["shared"]
    assert tm.LAUNCHES_BY_TABLES["global"] == before["global"] + 3  # the third is queued
    counts, plain = {}, {}
    img, rays = tm.render_image_mesh_kernel(packed, cam, sample_offset=2, counts=counts, **frame)
    assert r.last_frame_rays == int(rays)
    assert r.last_frame_tri_tests == int(counts["tri_tests"])
    assert r.last_frame_masked_visits == int(counts["masked_visits"])
    assert r.last_frame_coarse_skips == int(counts["coarse_skips"])
    ref, ref_rays = tm.render_image_mesh_plain(packed, cam, counts=plain, sample_offset=2,
                                               **frame)
    _assert_close(ref, ref_rays, img, rays)
    for key in ("tri_tests", "masked_visits", "coarse_skips"):
        want = int(plain[key])
        assert want > 0 and abs(int(counts[key]) - want) <= want * 2e-3


def _lamp_lit(mesh, dev):
    """``mesh`` under a 1.6 x 1.2 emissive quad above its middle spheres
    (two faces, brute-forced as globals)."""
    return concat_meshes(mesh, quad((-0.8, 2.6, -3.6), (0.8, 2.6, -3.6), (0.8, 2.6, -2.4),
                                    (-0.8, 2.6, -2.4), Material.emissive((12.0, 10.0, 8.0)), dev))


TWO_LEVEL_CASES = {
    # meshes whose tables the kernel reads from global memory: the 15,362-face
    # grid (f = 1) has no coarse level, the 102,402-face one (f = 2) has
    "15k": (lambda dev: mesh_demo_scene(4, device=dev), {}),
    "15k-nee": (lambda dev: _lamp_lit(mesh_demo_scene(4, device=dev), dev),
                dict(sky="black", nee=True)),
    "102k": (lambda dev: mesh_demo_scene(5, spheres=5, device=dev), {}),
    "102k-nee": (lambda dev: _lamp_lit(mesh_demo_scene(5, spheres=5, device=dev), dev),
                 dict(sky="black", nee=True)),
}
# sha256 of the float32 image bytes and the ray count of each case's
# MESH_KW frame, as the flat walk (the kernel before its coarse level)
# rendered them on an H100
PINNED_TWO_LEVEL_FRAMES = {
    "15k": ("d1574e0797c899f0e7cf6fd51cf1814773c0bec4a982075e51a6503dababbdf5", 7431),
    "15k-nee": ("39dcbbede2a51f8eccb20b99428a909b7157dcb9be0340c7e5400eec1596df53", 7431),
    "102k": ("0c9aa884767c1db94431d716558502bb164321ba8e4a83e411afdbb9d083cde0", 7649),
    "102k-nee": ("b87292fcfb47652123681501aa6fbaf96d60812c1b826270d381f5b8343ecacd", 7649),
}


@pytest.mark.parametrize("case", sorted(TWO_LEVEL_CASES))
def test_the_two_level_walk_matches_its_plain_version(cuda, case):
    """The kernel's walk over tables in global memory (15,362 and 102,402
    faces, with and without NEE): flat on the grid without a coarse level,
    two-level on the one with (blocks of 8 voxels on an edge). On the
    frame's first bounce, where both sides trace the same camera rays, its
    segments, triangle tests, masked visits and coarse skips are the plain
    walk's exactly, and it skips where the grid has a coarse level and
    nowhere else; over six bounces its image is the plain version's within
    ``_assert_close`` and its counts within the segments' 2e-3; and its
    frame is bit for bit the one the flat walk rendered."""
    make, extra = TWO_LEVEL_CASES[case]
    packed = tm.pack_mesh(make(cuda))
    assert packed.table_bytes > tm.table_limit(cuda.index or 0)
    two_level = not case.startswith("15k")
    assert packed.grid.static.coarse_block == (8 if two_level else 0)
    cam = _mesh_cam((0.0, 1.6, 2.2), cuda)
    for bounces in (1, MESH_KW["max_bounces"]):
        kw = {**MESH_KW, **extra, "max_bounces": bounces}
        counts, plain = {}, {}
        img, rays = tm.render_image_mesh_kernel(packed, cam, counts=counts, **kw)
        ref, ref_rays = tm.render_image_mesh_plain(packed, cam, counts=plain, **kw)
        torch.cuda.synchronize()
        _assert_close(ref, ref_rays, img, rays)
        keys = ("tri_tests", "masked_visits", "coarse_skips")
        if bounces == 1:
            assert int(rays) == int(ref_rays)
            assert [int(counts[k]) for k in keys] == [int(plain[k]) for k in keys]
        for key in keys:
            want = int(plain[key])
            assert (want > 0 or (key == "coarse_skips" and not two_level)), key
            assert abs(int(counts[key]) - want) <= want * 2e-3, key
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == PINNED_TWO_LEVEL_FRAMES[case]


# --- the tape kernel's leaf-interval count ------------------------------------

def _many_objects(dev):
    return many_objects_scene(99).compile(k=4, device=dev)


LEAF_CASES = {
    # (tape, partition, camera, frame, mode options)
    "deepcsg-clustered": (_deepcsg, "auto", ((0, 2.0, 7.0), (0.5, 0, 0), 40.0),
                          dict(width=96, height=54, spp=2, max_bounces=5, seed=5), {}),
    "deepcsg-audit": (_deepcsg, "auto", ((0, 2.0, 7.0), (0.5, 0, 0), 40.0),
                      dict(width=96, height=54, spp=2, max_bounces=5, seed=5),
                      dict(with_overflow=True)),
    "manyobjects-clustered": (_many_objects, "auto", ((0, 7.0, 9.0), (0, 0.4, 0), 45.0),
                              dict(width=128, height=72, spp=2, max_bounces=8, seed=2**31 + 11),
                              {}),
    "csgnight-clustered-nee": (lambda dev: csg_night_scene().compile(k=4, device=dev), "auto",
                               ((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), 38.0),
                               dict(width=64, height=32, spp=2, max_bounces=6, seed=2,
                                    sky="black"), dict(nee=True)),
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_tape_kernel_counts_the_plain_versions_leaf_tests(cuda, case):
    """The launch's leaf-interval word (an int64 tensor on the card, filled
    with nothing waiting) is what the plain version counts: leaves x
    segments on deepcsg's 8 leaves (the event flip in 2 clusters and the
    audit), and on the many-objects scene's 199 leaves in 100 clusters,
    whose event flip walks the cluster tree, the plain version's replay of
    the walks, fewer than leaves x segments, with the attribution's leaf
    scores in a second word; NEE's shadow rays are not counted. The replay
    equals the kernel's words exactly on the same segments (the frame's
    first bounce); over eight bounces the two sides' paths part on a few
    pixels (one row of this frame: 6 segments, 18 intervals), so there the
    words agree within 2e-3, as the mesh kernel's walk counts do."""
    make_tape, partition, (eye, at, vfov), frame, extra = LEAF_CASES[case]
    packed = tk.pack_program(make_tape(cuda), partition)
    tree = tk.uses_tree(packed, extra.get("nee", False), extra.get("with_overflow", False))
    assert tree == (case == "manyobjects-clustered")
    cam = Camera.look_at(eye, at, vfov_degrees=vfov,
                         aspect_ratio=frame["width"] / frame["height"], device=cuda)
    counts, plain = {}, {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tk.render_image_tape_kernel(packed, cam, counts=counts, **frame, **extra)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tests = counts["leaf_tests"]
    assert tests.dtype == torch.int64 and tests.device.type == "cuda"
    ref = tk.render_image_tape_plain(packed, cam, counts=plain, **frame, **extra)
    leaves = packed.tape.n_leaves
    if tree:
        assert int(tests) < int(out[1]) * leaves
        for key in ("leaf_tests", "leaf_scores"):
            want = int(plain[key])
            assert want > 0 and abs(int(counts[key]) - want) <= want * 2e-3
        first, first_plain = {}, {}
        one = {**frame, "max_bounces": 1}
        _, rays = tk.render_image_tape_kernel(packed, cam, counts=first, **one)
        _, ref_rays = tk.render_image_tape_plain(packed, cam, counts=first_plain, **one)
        assert int(rays) == int(ref_rays) == frame["width"] * frame["height"] * frame["spp"]
        assert int(first["leaf_tests"]) == int(first_plain["leaf_tests"]) < int(rays) * leaves
        assert int(first["leaf_scores"]) == int(first_plain["leaf_scores"]) > 0
    else:
        assert int(tests) == int(out[1]) * leaves
        assert int(plain["leaf_tests"]) == int(ref[1]) * leaves
        assert "leaf_scores" not in counts
    _assert_close(ref[0], ref[1], out[0], out[1])


# sha256 of the float32 image bytes and the ray count of the 99-object
# scene's event-flip frame, as the flat loops over every cluster and every
# leaf rendered it on an H100: the walks through the cluster tree must keep
# giving it
PINNED_TREE_FRAME = ("19d0f349f87b95bbe7531fa28d5532fb442b6dc27c1b1261ce799f536b586b5d", 43484)


def test_the_cluster_tree_keeps_the_flat_loops_frame(cuda):
    packed = tk.pack_program(_many_objects(cuda))
    assert packed.tree is not None
    cam = Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0, aspect_ratio=128 / 72,
                         device=cuda)
    before = dict(tk.LAUNCHES_BY_SEARCH)
    img, rays = tk.render_image_tape_kernel(packed, cam, 128, 72, spp=2, max_bounces=8, seed=7)
    torch.cuda.synchronize()
    assert tk.LAUNCHES_BY_SEARCH == {**before, "tree": before["tree"] + 1}
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == PINNED_TREE_FRAME


@pytest.mark.parametrize("make_tape,eye,at,vfov,leaves",
                         [(_many_objects, (0, 7.0, 9.0), (0, 0.4, 0), 45.0, 199),
                          (_deepcsg, (0, 2.0, 7.0), (0.5, 0, 0), 40.0, 8)],
                         ids=["manyobjects", "deepcsg"])
def test_the_renderer_reads_the_leaf_tests_at_its_fence(cuda, make_tape, eye, at, vfov, leaves):
    """``PathTraceRenderer.last_frame_leaf_tests`` of a progressive tape
    frame, queued behind the one before, is the kernel's count of that
    frame, read at the fence with its segments: leaves x segments on
    deepcsg; on the many-objects scene, whose event flip walks the cluster
    tree, the plain version's replay of the walks, fewer, with the leaf
    scores in ``last_frame_leaf_scores`` (None without the tree); a mesh
    frame has none."""
    cam = Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=2.0, device=cuda)
    frame = dict(width=64, height=32, spp=2, max_bounces=8, seed=2)
    r = PathTraceRenderer(make_tape(cuda), cam, RenderConfig(**frame), progressive=True,
                          device=cuda)
    assert r._schedule == "queue" and r._packed.mode == "clustered"
    tree = r._packed.tree is not None
    assert tree == (leaves == 199)
    for k in range(3):
        r.draw_frame(0.0)
        counts, plain = {}, {}
        _, rays = tk.render_image_tape_kernel(r._packed, cam, counts=counts,
                                              sample_offset=k * frame["spp"], **frame)
        assert r.last_frame_rays == int(rays)
        if not tree:
            assert r.last_frame_leaf_tests == int(counts["leaf_tests"]) == leaves * int(rays)
            assert r.last_frame_leaf_scores is None
            continue
        tk.render_image_tape_plain(r._packed, cam, counts=plain, sample_offset=k * frame["spp"],
                                   **frame)
        assert r.last_frame_leaf_tests == int(counts["leaf_tests"]) == int(plain["leaf_tests"])
        assert r.last_frame_leaf_tests < leaves * int(rays)
        assert r.last_frame_leaf_scores == int(counts["leaf_scores"]) == int(plain["leaf_scores"])
    s = PathTraceRenderer(mesh_demo_scene(2, device=cuda), cam, RenderConfig(**frame),
                          progressive=True, device=cuda)
    s.draw_frame(0.0)
    assert s.last_frame_leaf_tests is None and s.last_frame_tri_tests > 0


# --- the a-trous filter ------------------------------------------------------

ATROUS_TOL = 1e-5  # max abs on the linear image: the same float operations on both sides


@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("iterations", [1, 2, 3, 4])
def test_atrous_kernel_matches_plain(cuda, iterations, demodulate):
    """The kernel's passes (steps 1 to 2^(iterations-1), up to 8) on a
    2-spp RTIOW frame and its AOVs at 64x32, against the plain version on
    the card: within ATROUS_TOL, each pass one launch."""
    cam = _rtiow_camera(2.0, cuda)
    scene = rtiow_final_scene(grid=4, device=cuda)
    raw, _ = mk.render_image_kernel(mk.pack_scene(scene), cam, 64, 32, spp=2, max_bounces=8,
                                    seed=3, lens=True)
    aovs = render_aovs(scene.nearest_hit, cam, 64, 32)
    before = atrous.LAUNCHES
    got = denoise.atrous_denoise(raw, aovs, iterations=iterations, demodulate=demodulate)
    torch.cuda.synchronize()
    assert atrous.LAUNCHES == before + iterations
    ref = denoise.atrous_denoise_plain(raw, aovs, iterations=iterations, demodulate=demodulate)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= ATROUS_TOL


def _denoised_renderer(cuda):
    cam = _rtiow_camera(2.0, cuda)
    cfg = RenderConfig(width=64, height=32, spp=2, lens=True, denoise=True, denoise_iterations=3)
    return PathTraceRenderer(rtiow_final_scene(grid=4, device=cuda), cam, cfg,
                             advance_samples=True)


def test_denoised_frame_launches_the_kernel_and_never_the_plain_filter(cuda, monkeypatch):
    """A denoised frame on the card launches the a-trous kernel once per
    pass and never enters the plain filter; the asynchronous frame waits
    for nothing on the host (sync debug mode "error" raises on a wait)."""
    def refuse(*a, **k):
        raise AssertionError("the plain filter ran on the card")

    monkeypatch.setattr(denoise, "atrous_denoise_plain", refuse)
    monkeypatch.setattr(denoise, "atrous_pass_plain", refuse)
    r = _denoised_renderer(cuda)
    before = atrous.LAUNCHES
    img = r.draw_frame(0.0)
    assert atrous.LAUNCHES == before + 3 and img.shape == (32, 64, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, rays = r.draw_frame_async(0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert atrous.LAUNCHES == before + 6 and int(rays) > 0


def test_atrous_ragged_frame_matches_plain_bitwise(cuda):
    """A 97x55 frame (no 16x16 block divides it) at 5 passes, so the last
    pass's step, 16, exceeds a block and every sub-lattice is ragged: the
    kernel equals the plain version bit for bit, with and without
    demodulation."""
    cam = _rtiow_camera(97 / 55, cuda)
    scene = rtiow_final_scene(grid=4, device=cuda)
    raw, _ = mk.render_image_kernel(mk.pack_scene(scene), cam, 97, 55, spp=2, max_bounces=8,
                                    seed=5, lens=True)
    aovs = render_aovs(scene.nearest_hit, cam, 97, 55)
    for demodulate in (True, False):
        got = denoise.atrous_denoise(raw, aovs, iterations=5, demodulate=demodulate)
        ref = denoise.atrous_denoise_plain(raw, aovs, iterations=5, demodulate=demodulate)
        assert torch.equal(got, ref), float((got - ref).abs().max())


# --- the sphere kernel's G-buffer mode ----------------------------------------

GBUFFER_CASES = {  # name -> (scene, camera eye, look-at, vfov, lens kwargs, expected mode)
    "grid-rtiow": (lambda dev: rtiow_final_scene(device=dev), (13, 2, 3), (0, 0, 0), 20.0,
                   dict(aperture=0.1, focus_dist=10.0), "grid"),
    "brute-two_spheres": (lambda dev: two_spheres_scene(device=dev), (0, 0, 0), (0, 0, -1), 90.0,
                          {}, "brute"),
}


@pytest.mark.parametrize("sky", ["rtiow", "wololo", "black"])
@pytest.mark.parametrize("case", sorted(GBUFFER_CASES))
def test_gbuffer_kernel_matches_plain(cuda, case, sky):
    """The G-buffer mode at 160x90 equals its plain version on the card
    (``render_aovs`` through the packed scene's plain hit function) bit
    for bit, in one launch."""
    make, eye, at, vfov, lens, mode = GBUFFER_CASES[case]
    packed = mk.pack_scene(make(cuda))
    assert packed.mode == mode
    cam = Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=16 / 9, device=cuda, **lens)
    before = mk.LAUNCHES_BY_MODE["gbuffer"]
    got = mk.render_aovs_kernel(packed, cam, 160, 90, sky=sky)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_MODE["gbuffer"] == before + 1
    ref = mk.render_aovs_plain(packed, cam, 160, 90, sky=sky)
    assert got.hit.dtype == torch.bool and bool(got.hit.any()) and not bool(got.hit.all())
    for name, a, b in zip(("depth", "normal", "albedo", "hit"), got, ref):
        assert torch.equal(a, b), name


def test_gbuffer_global_tables_equal_the_staged_cast(cuda):
    """The G-buffer cast with its tables read from global memory (forced
    through the test-only argument) equals the staged cast bit for bit on
    the RTIOW scene, whose tables the size rule stages."""
    packed = mk.pack_scene(rtiow_final_scene(device=cuda))
    assert packed.table_bytes <= mk.table_limit(cuda.index or 0)
    cam = _rtiow_camera(16 / 9, cuda)
    before = dict(mk.LAUNCHES_BY_TABLES)
    staged = mk.render_aovs_kernel(packed, cam, 160, 90)
    global_ = mk.render_aovs_kernel(packed, cam, 160, 90, force_global=True)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_TABLES == {"shared": before["shared"] + 1,
                                     "global": before["global"] + 1}
    assert bool(staged.hit.any())
    for name, a, b in zip(("depth", "normal", "albedo", "hit"), staged, global_):
        assert torch.equal(a, b), name


def test_gbuffer_over_the_limit_reads_global_memory(cuda):
    """rtiow_final_scene(grid=40)'s tables exceed a block's shared memory:
    the G-buffer launcher reads them from global memory by size, and the
    cast equals its plain version bit for bit."""
    packed = mk.pack_scene(rtiow_final_scene(grid=40, device=cuda))
    assert packed.table_bytes > mk.table_limit(cuda.index or 0)
    cam = _rtiow_camera(16 / 9, cuda)
    before = dict(mk.LAUNCHES_BY_TABLES)
    got = mk.render_aovs_kernel(packed, cam, 160, 90)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_TABLES == {"shared": before["shared"], "global": before["global"] + 1}
    ref = mk.render_aovs_plain(packed, cam, 160, 90)
    for name, a, b in zip(("depth", "normal", "albedo", "hit"), got, ref):
        assert torch.equal(a, b), name


def test_gbuffer_cast_replayed_from_a_cuda_graph_equals_the_eager_cast(cuda):
    """The G-buffer cast captured alone in a CUDA graph, where the caching
    allocator hands out a fresh pool, equals the eager cast on every
    replay: the camera row the launch reads lives until the launch."""
    packed = mk.pack_scene(rtiow_final_scene(device=cuda))
    cam = _rtiow_camera(16 / 9, cuda)
    ref = mk.render_aovs_kernel(packed, cam, 320, 180)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            got = mk.render_aovs_kernel(packed, cam, 320, 180)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for name, a, b in zip(("depth", "normal", "albedo", "hit"), got, ref):
            assert torch.equal(a, b), name


def test_denoised_sphere_frame_casts_through_the_gbuffer_kernel(cuda, monkeypatch):
    """A denoised sphere frame on the card launches the G-buffer mode once
    a frame over the renderer's packed scene and never the plain cast."""
    from csgrenderer_tpu_torch.app import renderers

    def refuse(*a, **k):
        raise AssertionError("the plain AOV cast ran on the card")

    monkeypatch.setattr(renderers, "render_aovs", refuse)
    r = _denoised_renderer(cuda)
    before = mk.LAUNCHES_BY_MODE["gbuffer"]
    r.draw_frame(0.0)
    r.draw_frame_async(0.1)
    torch.cuda.synchronize()
    assert mk.LAUNCHES_BY_MODE["gbuffer"] == before + 2


# --- the live frame replayed from a CUDA graph ---------------------------------

LIVE = RenderConfig(width=1280, height=720, spp=2, lens=True, denoise=True, denoise_iterations=4)


def _live_renderer(cuda, camera=None):
    """The live denoised RTIOW frame: 1280x720, 2 spp, 4 a-trous passes,
    fresh noise every frame."""
    cam = _rtiow_camera(16 / 9, cuda) if camera is None else camera
    return PathTraceRenderer(rtiow_final_scene(device=cuda), cam, LIVE, advance_samples=True)


def _eager_frames(cuda, monkeypatch, cameras, offsets):
    """The live frames at ``offsets``, each at its view of ``cameras`` (or
    all at one camera), each enqueued launch by launch."""
    cameras = cameras if isinstance(cameras, list) else [cameras] * len(offsets)
    with monkeypatch.context() as m:
        m.setattr(renderers, "frame_schedule", lambda *a: "eager")
        r = _live_renderer(cuda, cameras[0])
        frames = []
        for camera, offset in zip(cameras, offsets, strict=True):
            r.set_camera(camera)
            r._sample_offset = offset
            frames.append(r.draw_frame_async(0.0))
        torch.cuda.synchronize()
    assert r._graph is None
    return frames


def _assert_frames_equal(got, ref):
    for k, ((img, rays), (ref_img, ref_rays)) in enumerate(zip(got, ref, strict=True)):
        assert img.dtype == torch.uint8 and torch.equal(img, ref_img), k
        assert int(rays) == int(ref_rays), k


def test_replayed_frames_equal_eager_frames(cuda, monkeypatch):
    """The first frame runs eagerly, the second is captured and
    replayed, and eight more replay: each equals the eager frame at its
    offset bit for bit (image and segment count); no returned image is the
    graph's own buffer, so the first frames are unchanged after the later
    replays; each replay counts two sphere kernel launches (the beauty
    frame and the G-buffer cast) and four a-trous passes."""
    r = _live_renderer(cuda)
    captures, replays = frame_graph.CAPTURES, frame_graph.REPLAYS
    frames = [r.draw_frame_async(0.0), r.draw_frame_async(0.0)]
    torch.cuda.synchronize()
    kept = [img.clone() for img, _ in frames]
    assert frame_graph.CAPTURES == captures + 1 and frame_graph.REPLAYS == replays + 1
    before = (mk.LAUNCHES, mk.LAUNCHES_BY_MODE["gbuffer"], atrous.LAUNCHES)
    frames += [r.draw_frame_async(0.0) for _ in range(8)]
    torch.cuda.synchronize()
    assert (mk.LAUNCHES, mk.LAUNCHES_BY_MODE["gbuffer"], atrous.LAUNCHES) == (
        before[0] + 16, before[1] + 8, before[2] + 32)
    assert frame_graph.CAPTURES == captures + 1 and frame_graph.REPLAYS == replays + 9
    out = r._graph.out
    static = range(out.data_ptr(), out.data_ptr() + out.numel())
    assert not any(t.data_ptr() in static for frame in frames for t in frame)
    for (img, _), first in zip(frames, kept):
        assert torch.equal(img, first)
    _assert_frames_equal(frames, _eager_frames(cuda, monkeypatch, r.camera,
                                               [k * LIVE.spp for k in range(10)]))


def test_set_camera_keeps_the_graph_and_reset_restarts_the_offset(cuda, monkeypatch):
    """An orbit drag: ``set_camera`` before each of four frames, enqueued
    with no wait between them, keeps the graph, and each replayed frame
    equals the eager frame of its view; after ``reset_accumulation`` the
    replayed frame is the one at offset 0."""
    first = _rtiow_camera(16 / 9, cuda)
    r = _live_renderer(cuda, first)
    for _ in range(3):
        r.draw_frame_async(0.0)
    captures = frame_graph.CAPTURES
    views = [Camera.look_at((12 - k, 2.5, 4 + k), (0, 0, 0), vfov_degrees=20.0,
                            aspect_ratio=16 / 9, aperture=0.1, focus_dist=10.0, device=cuda)
             for k in range(4)]
    moved = []
    for view in views:
        r.set_camera(view)
        moved.append(r.draw_frame_async(0.0))
    r.reset_accumulation()
    restarted = r.draw_frame_async(0.0)
    torch.cuda.synchronize()
    assert frame_graph.CAPTURES == captures and r._sample_offset == LIVE.spp
    _assert_frames_equal(moved + [restarted], _eager_frames(
        cuda, monkeypatch, views + [views[-1]], [k * LIVE.spp for k in range(3, 7)] + [0]))
    assert not torch.equal(moved[0][0], moved[1][0])


def test_one_capture_over_a_100_frame_app_run(cuda):
    """``App.run`` with two frames in flight and the fence readback, as the
    live benchmark cell drives it: one eager frame, one capture, 99
    replays."""
    r = _live_renderer(cuda)
    captures, replays = frame_graph.CAPTURES, frame_graph.REPLAYS
    app = App(width=LIVE.width, height=LIVE.height, stats=StatsClock(emit=None))
    app.swap_scene(r)
    assert app.run(max_frames=100, frames_in_flight=2, readback="fence")
    torch.cuda.synchronize()
    assert frame_graph.CAPTURES == captures + 1 and frame_graph.REPLAYS == replays + 99


# --- the next progressive frame queued behind the current one -------------

QUEUED_CASES = {
    "rtiow-grid-lens": (lambda dev: rtiow_final_scene(device=dev),
                        lambda dev: _rtiow_camera(2.0, dev),
                        RenderConfig(width=64, height=32, spp=2, max_bounces=8, seed=3, lens=True)),
    "night-grid-nee": (lambda dev: night_scene(grid=11, device=dev), _night_cam,
                       RenderConfig(**NEE_KW)),
    "deepcsg-tape": (_deepcsg,
                     lambda dev: Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                                                aspect_ratio=2.0, device=dev),
                     RenderConfig(width=64, height=32, spp=2, max_bounces=5, seed=5)),
}
def _other_view(r):
    return Camera.look_at((12, 2.5, 4), (0, 0, 0), vfov_degrees=20.0, aspect_ratio=2.0,
                          aperture=0.1, focus_dist=10.0, device=r.device)


QUEUE_STEPS = {
    "reset_accumulation": lambda r: r.reset_accumulation(),
    "set_camera": lambda r: r.set_camera(_other_view(r)),
    "render_to_noise": lambda r: r.render_to_noise(target=1e-9, max_spp=4 * r.config.spp),
    "camera assigned": lambda r: setattr(r, "camera", _other_view(r)),
}


def _progressive_frames(cuda, monkeypatch, case, steps, queue=True):
    """A progressive renderer of ``case`` through ``steps`` (None: a
    ``draw_frame``; else a call on the renderer): (the renderer, each
    frame's image, accumulator and counts). ``queue=False`` makes the
    renderer eager by the one decision (``renderers.frame_schedule``)."""
    make_scene, make_cam, cfg = QUEUED_CASES[case]
    with monkeypatch.context() as m:
        if not queue:
            m.setattr(renderers, "frame_schedule", lambda *a: "eager")
        r = PathTraceRenderer(make_scene(cuda), make_cam(cuda), cfg, progressive=True)
        frames = []
        for step in steps:
            if step is not None:
                step(r)
                continue
            image = r.draw_frame(0.0)
            acc = r.accumulator
            frames.append((image, acc.radiance_sum, acc.sample_count, acc.rays_traced,
                           r.last_frame_rays, r.last_frame_shadow_rays))
        torch.cuda.synchronize()
    return r, frames


def _assert_progressive_equal(got, ref):
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref, strict=True)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), k
        assert int(a[2]) == int(b[2]) and a[3:] == b[3:], k


@pytest.mark.parametrize("case", sorted(QUEUED_CASES))
def test_queued_progressive_frames_equal_eager_frames(cuda, monkeypatch, case):
    """Six progressive frames back to back, the later ones each adopting
    the frame the call before queued: images, accumulators, segments and
    shadow rays equal bit for bit those of a renderer that never queues."""
    r, got = _progressive_frames(cuda, monkeypatch, case, [None] * 6)
    assert r._ahead is not None
    _, ref = _progressive_frames(cuda, monkeypatch, case, [None] * 6, queue=False)
    _assert_progressive_equal(got, ref)
    assert all(f[4] > 0 for f in got)
    assert all((f[5] > 0) if r.config.nee else f[5] == 0 for f in got)


@pytest.mark.parametrize("step", sorted(QUEUE_STEPS))
def test_a_state_change_between_queued_frames_gives_the_eager_frames(cuda, monkeypatch, step):
    """``reset_accumulation``, ``set_camera``, ``render_to_noise`` or an
    assigned camera between queued frames: every frame after it equals an
    eager renderer's through the same steps, so the frame queued before
    the change is never used."""
    steps = [None] * 3 + [QUEUE_STEPS[step]] + [None] * 3
    _, got = _progressive_frames(cuda, monkeypatch, "rtiow-grid-lens", steps)
    _, ref = _progressive_frames(cuda, monkeypatch, "rtiow-grid-lens", steps, queue=False)
    _assert_progressive_equal(got, ref)


def test_one_draw_frame_enqueues_one_render_kernel(cuda, monkeypatch):
    """A one-shot progressive frame launches one sphere kernel and queues
    nothing; the second back-to-back frame launches its own and queues the
    third."""
    renders = []
    render = PathTraceRenderer._render
    monkeypatch.setattr(PathTraceRenderer, "_render",
                        lambda self, *a, **kw: (renders.append(self._sample_offset),
                                                render(self, *a, **kw))[1])
    make_scene, make_cam, cfg = QUEUED_CASES["rtiow-grid-lens"]
    r = PathTraceRenderer(make_scene(cuda), make_cam(cuda), cfg, progressive=True)
    before = mk.LAUNCHES
    r.draw_frame(0.0)
    torch.cuda.synchronize()
    assert renders == [0] and mk.LAUNCHES == before + 1 and r._ahead is None
    r.draw_frame(0.0)
    torch.cuda.synchronize()
    assert renders == [0, cfg.spp, 2 * cfg.spp] and mk.LAUNCHES == before + 3


def _frames_without_a_sync(r, draw, warm, n):
    """``warm`` draws, then ``n`` more under ``set_sync_debug_mode("error")``
    (which raises at any synchronising call): each draw's result with the
    counts its fence read."""
    frames = [draw(r) for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames += [draw(r) for _ in range(n)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return frames


def test_an_adopted_frame_waits_on_its_event_alone(cuda, monkeypatch):
    """Once the queue runs, a progressive frame synchronises no stream: its
    one wait is the event behind its counts; its image, accumulator and
    counts equal the eager renderer's bit for bit."""
    make_scene, make_cam, cfg = QUEUED_CASES["night-grid-nee"]
    r = PathTraceRenderer(make_scene(cuda), make_cam(cuda), cfg, progressive=True)

    def draw(r):
        image = r.draw_frame(0.0)
        acc = r.accumulator
        return (image, acc.radiance_sum, acc.sample_count, acc.rays_traced, r.last_frame_rays,
                r.last_frame_shadow_rays)

    got = _frames_without_a_sync(r, draw, 2, 3)
    assert r._schedule == "queue" and r.last_frame_rays > 0 and r.last_frame_shadow_rays > 0
    _, ref = _progressive_frames(cuda, monkeypatch, "night-grid-nee", [None] * 5, queue=False)
    _assert_progressive_equal(got, ref)


def test_a_replayed_draw_frame_waits_on_its_event_alone(cuda, monkeypatch):
    """A synchronous ``draw_frame`` of the live frame, once replayed from
    its graph, synchronises no stream: its one wait is the event behind its
    count; each frame equals the eager frame at its offset bit for bit."""
    r = _live_renderer(cuda)
    got = _frames_without_a_sync(r, lambda r: (r.draw_frame(0.0), r.last_frame_rays), 2, 3)
    assert r._schedule == "replay" and r._graph is not None
    _assert_frames_equal(got, _eager_frames(cuda, monkeypatch, r.camera,
                                            [k * LIVE.spp for k in range(5)]))


# --- the kernels' stats mode ------------------------------------------------------

STATS_CASES = {
    # (kernel wrapper, packed scene, camera, frame, the pinned frame it renders, the
    # stats words it writes, the plain walk's key in its plain version's counts)
    "rtiow-grid": (mk.render_image_kernel, lambda dev: mk.pack_scene(rtiow_final_scene(device=dev)),
                   lambda dev: _rtiow_camera(2.0, dev),
                   dict(width=64, height=32, spp=2, max_bounces=8, seed=11, lens=True),
                   PINNED_FRAMES["grid"], 3, "cell_visits"),
    "night488-grid-nee": (mk.render_image_kernel, NEE_CASES["grid-nee"][0], _night_cam, NEE_KW,
                          PINNED_NEE_FRAMES["grid-nee"], 4, "cell_visits"),
    "deepcsg-flat": (tk.render_image_tape_kernel, lambda dev: tk.pack_program(_deepcsg(dev)),
                     lambda dev: Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0,
                                                aspect_ratio=96 / 54, device=dev),
                     dict(width=96, height=54, spp=2, max_bounces=5, seed=5),
                     PINNED_FRAMES["clustered"], 1, None),
    "manyobjects-tree": (tk.render_image_tape_kernel,
                         lambda dev: tk.pack_program(_many_objects(dev)),
                         lambda dev: Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0,
                                                    aspect_ratio=128 / 72, device=dev),
                         dict(width=128, height=72, spp=2, max_bounces=8, seed=7),
                         PINNED_TREE_FRAME, 3, "node_visits"),
    "mesh-global-grid": (tm.render_image_mesh_kernel, MESH_CASES["grid"][0],
                         lambda dev: _mesh_cam(MESH_CASES["grid"][1], dev), MESH_KW,
                         PINNED_MESH_TAPE_FRAMES["mesh-grid"], 3, "voxel_visits"),
}
STATS_WORDS = build.STATS_WORDS


def _stats_pair(case, dev, **frame):
    """(stats launch's (image, rays, counts), the next launch's), both of
    case's frame (with ``frame`` over it) under recording: the first launch
    after ``profiling.clear()`` is a stats launch, the second is not."""
    render, make_packed, make_cam, kw, _, _, _ = STATS_CASES[case]
    packed, cam = make_packed(dev), make_cam(dev)
    out = []
    with profiling.recording():
        profiling.clear()
        for _ in range(2):
            counts = {}
            img, rays = render(packed, cam, counts=counts, **{**kw, **frame})
            out.append((img, rays, counts))
    profiling.clear()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_a_stats_launch_renders_the_plain_launchs_frame_and_counts(cuda, case):
    """The stats instantiation (the first launch while spans record) gives
    the pinned image and segments and the counts of the launch without
    stats bit for bit, and a block of the case's words whose lane shares
    lie in (0, 100%]: segments over 32 x the segment loop's warp turns,
    the walk's lane turns over 32 x its warp turns."""
    _, _, _, _, pinned, n_words, walk = STATS_CASES[case]
    (img, rays, counts), (img2, rays2, counts2) = _stats_pair(case, cuda)
    assert "stats" in counts and "stats" not in counts2
    assert torch.equal(img, img2) and int(rays) == int(rays2)
    assert counts.keys() - {"stats"} == counts2.keys()
    for key in counts2:
        assert int(counts[key]) == int(counts2[key]), key
    digest = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    assert (digest, int(rays)) == pinned[:2]
    stats = counts["stats"]
    assert stats.dtype == torch.int64 and stats.device.type == "cuda"
    words = dict(zip(STATS_WORDS, stats.tolist()))
    assert len(words) == n_words
    assert 0 < int(rays) <= 32 * words["segment_warp_steps"]
    assert words["segment_warp_steps"] <= int(rays)
    if walk is not None:
        assert 0 < words["walk_warp_steps"] <= words["walk_lane_steps"]
        assert words["walk_lane_steps"] <= 32 * words["walk_warp_steps"]
    if n_words == 4:
        assert 0 < words["shadow_lane_steps"] < words["walk_lane_steps"]


def _plain_walk(case, dev, path_only=False, **frame):
    """The plain version's walk count of case's frame (with ``frame`` over
    it): the key of its counts, or with ``path_only`` (NEE) the path
    segments' walks and the shadow rays' apart."""
    render, make_packed, make_cam, kw, _, _, walk = STATS_CASES[case]
    packed, cam = make_packed(dev), make_cam(dev)
    kw = {**kw, **frame}
    if not path_only:
        plain = {}
        if render is mk.render_image_kernel:
            mk.render_image_plain(packed, cam, counts=plain, **kw)
        elif render is tm.render_image_mesh_kernel:
            tm.render_image_mesh_plain(packed, cam, counts=plain, **kw)
            return int(plain[walk]) + int(plain["coarse_skips"])  # a turn either kind
        else:
            tk.render_image_tape_plain(packed, cam, counts=plain, **kw)
        return int(plain[walk])
    path, shadow = {}, {}
    integrator.render_image(mk.plain_hit_fn(packed, path), cam, kw["width"], kw["height"],
                            spp=kw["spp"], max_bounces=kw["max_bounces"], seed=kw["seed"],
                            sky=kw["sky"], lights=packed.lights,
                            shadow_hit_fn=mk.plain_hit_fn(packed, shadow))
    return int(path[walk]), int(shadow[walk])


@pytest.mark.parametrize("case", ["rtiow-grid", "manyobjects-tree", "mesh-global-grid"])
def test_a_stats_launch_counts_the_plain_walks_visits(cuda, case):
    """The stats block's walk lane turns are the plain version's walk
    count (the sphere grid's cell visits, the cluster tree's node visits,
    the mesh grid's voxel visits and coarse skips): exactly on the frame's
    first bounce,
    where both sides trace the same camera rays, and over the whole frame
    within the bound the segments are held to (``_assert_close``): the two
    sides' paths part on a few pixels where a scatter rounds apart (the
    leaf-test count of the tree frame differs by 18 of its intervals so);
    the mesh frame's walks, whose counts the mesh tests hold equal, agree
    exactly."""
    one = {"max_bounces": 1}
    (_, rays, counts), _ = _stats_pair(case, cuda, **one)
    walk = int(counts["stats"][2])
    assert walk == _plain_walk(case, cuda, **one) > 0
    (_, rays, counts), _ = _stats_pair(case, cuda)
    walk, want = int(counts["stats"][2]), _plain_walk(case, cuda)
    if case == "mesh-global-grid":
        assert walk == want
    assert want > 0 and abs(walk - want) <= max(want * 2e-3, 8)


def test_a_nee_stats_launch_counts_the_plain_walks_of_its_path_segments(cuda):
    """In the grid-NEE query loop the walk's lane turns less the shadow
    rays' are the plain version's path-segment cell visits (exactly on the
    first bounce, within the segments' bound over six). The shadow rays'
    walks cannot match the plain version's: a shadow ray's walk in the
    kernel starts its best t at the lamp's bound and is skipped where a
    global sphere occludes, while the plain version walks every shadow ray
    to its nearest hit, those of ended paths too; so the kernel's shadow
    turns lie above 0 and at most the plain shadow walks' visits."""
    for frame in ({"max_bounces": 1}, {}):
        (_, rays, counts), _ = _stats_pair("night488-grid-nee", cuda, **frame)
        words = dict(zip(STATS_WORDS, counts["stats"].tolist()))
        path, shadow = _plain_walk("night488-grid-nee", cuda, path_only=True, **frame)
        got = words["walk_lane_steps"] - words["shadow_lane_steps"]
        if frame:
            assert got == path
        assert path > 0 and abs(got - path) <= max(path * 2e-3, 8)
        assert 0 < words["shadow_lane_steps"] <= shadow


def test_the_renderer_records_the_stats_block_of_its_stats_launches(cuda, monkeypatch):
    """A progressive renderer under recording records, at each frame's fence,
    the frame's segments, and on the frames whose launch was a stats launch
    (the first and every ``STATS_EVERY``-th after it; every second here)
    the block that launch wrote, equal to a stats launch of the same frame
    made directly; the queued frames carry their own blocks."""
    monkeypatch.setattr(build, "STATS_EVERY", 2)
    render, make_packed, make_cam, kw, _, _, _ = STATS_CASES["rtiow-grid"]
    cam = make_cam(cuda)
    frame = {k: v for k, v in kw.items() if k != "lens"}
    r = PathTraceRenderer(rtiow_final_scene(device=cuda), cam,
                          RenderConfig(**frame, lens=True), progressive=True, device=cuda)
    assert r._schedule == "queue"
    profiling.clear()
    with profiling.recording():
        for _ in range(4):
            r.draw_frame(0.0)
    by_frame = {}
    for c in profiling.counters():
        by_frame.setdefault(c.frame, {})[c.name] = c.value
    profiling.clear()
    assert sorted(by_frame) == [1, 2, 3, 4]
    for k in range(4):
        got = by_frame[k + 1]
        with profiling.recording():
            profiling.clear()
            counts = {}
            _, rays = render(r._packed, cam, counts=counts, sample_offset=k * frame["spp"], **kw)
        profiling.clear()
        assert got["kernel.segments"] == int(rays)
        if k % 2:
            assert "kernel.segment_warp_steps" not in got
            continue
        assert [got["kernel." + w] for w in STATS_WORDS[:3]] == counts["stats"].tolist()
        assert "kernel.shadow_lane_steps" not in got
