"""The CUDA sphere kernel against its plain torch version, on the card.

Needs an NVIDIA GPU with nvcc: every test here carries the ``cuda`` marker
and skips where ``torch.cuda.is_available()`` is false. The file imports
no JAX, so it also runs on a host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version repeat the same float operations, so they agree
far inside the bounds used against the JAX reference
(tests/test_kernels.py::compare): RMSE <= 2e-2, at most 1% of pixels off
by more than 0.05, rays within max(2e-3 * ref, 8).
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene

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
