"""The CUDA sphere, tape and triangle-mesh kernels against their plain
torch versions, on the card, without and with next-event estimation (NEE).

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

from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
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
from csgrenderer_tpu_torch.render.trimesh import concat_meshes, icosphere, quad
from csgrenderer_tpu_torch.scene import Material

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
