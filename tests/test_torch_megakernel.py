"""The port's slice as a whole: ``render_image_kernel`` on CPU tensors
(its plain torch version) against the JAX package's jnp ``render_image``.

Both render the identical scene and camera (``convert``); bounds are those
of tests/test_kernels.py::compare: RMSE <= 2e-2, at most 1% of pixels off
by more than 0.05 in any channel, rays within max(2e-3 * ref, 8). Exact
equality is not expected: XLA's dot and fusion order differ from the
port's in the last bits, which flips rare silhouette hits.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels import render_image_pallas
from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
from csgrenderer_tpu.models import two_spheres_scene as j_two
from csgrenderer_tpu.render import render_image as j_render
from csgrenderer_tpu_torch.convert import camera_from_numpy, sphere_scene_from_numpy
from csgrenderer_tpu_torch.kernels import megakernel as mk

CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius")
SCENE_FIELDS = ("centers", "radii", "mat_kind", "albedo", "mat_param")


def port_of(jscene, jcam):
    scene = sphere_scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))
    cam = camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS))
    return scene, cam


def assert_compare(ref, ref_rays, img, rays):
    ref, img = np.asarray(ref), np.asarray(img)
    assert img.shape == ref.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    assert rmse <= 2e-2, f"rmse {rmse}"
    frac_bad = float((np.abs(ref - img).max(axis=-1) > 0.05).mean())
    assert frac_bad <= 0.01, f"{frac_bad:.3%} divergent pixels"
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)


def two_spheres_cam(aspect=2.0):
    return JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=aspect)


def rtiow_cam(aspect=2.0):
    return JCamera.look_at((13, 2, 3), (0, 0, 0), vfov_degrees=20, aspect_ratio=aspect,
                           aperture=0.1, focus_dist=10.0)


CASES = {
    "a-two-spheres": (j_two, two_spheres_cam, dict(width=64, height=32, spp=4, max_bounces=4, seed=5),
                      "brute"),
    "b-rtiow-grid4-lens": (lambda: j_rtiow(grid=4), rtiow_cam,
                           dict(width=64, height=32, spp=4, max_bounces=6, seed=7, lens=True),
                           "brute"),
    "c-rtiow-auto-grid": (j_rtiow, rtiow_cam,
                          dict(width=64, height=32, spp=2, max_bounces=4, seed=0, lens=True),
                          "grid"),
    "d-not-tile-aligned": (j_two, lambda: two_spheres_cam(50 / 30),
                           dict(width=50, height=30, spp=2, max_bounces=3, seed=1), "brute"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_jnp_reference(case):
    make_jscene, make_jcam, kw, mode = CASES[case]
    jscene, jcam = make_jscene(), make_jcam()
    ref, ref_rays = j_render(jscene.nearest_hit, jcam, **kw)
    scene, cam = port_of(jscene, jcam)
    assert mk.pack_scene(scene).mode == mode
    launches = mk.LAUNCHES
    img, rays = mk.render_image_kernel(scene, cam, **kw)
    assert mk.LAUNCHES == launches  # CPU tensors never reach the kernel
    assert rays.dtype == torch.int64 and img.device.type == "cpu"
    assert tuple(img.shape) == (kw["height"], kw["width"], 3)
    assert_compare(ref, ref_rays, img.numpy(), rays)


def test_grid_mode_equals_brute_mode_on_cpu():
    scene, cam = port_of(j_rtiow(), rtiow_cam())
    kw = dict(width=48, height=24, spp=2, max_bounces=6, seed=3, lens=True)
    grid, grid_rays = mk.render_image_kernel(scene, cam, worklist=True, **kw)
    brute, brute_rays = mk.render_image_kernel(scene, cam, worklist=False, **kw)
    # the same quadratic arithmetic on the same spheres: the walk only
    # skips spheres that cannot be nearest
    assert int(grid_rays) == int(brute_rays)
    assert torch.equal(grid, brute)


def test_matches_pallas_kernel_in_interpret_mode():
    jscene, jcam = j_two(), two_spheres_cam()
    kw = dict(width=64, height=32, spp=4, max_bounces=4, seed=5)
    ref, ref_rays = render_image_pallas(jscene, jcam, interpret=True, **kw)
    scene, cam = port_of(jscene, jcam)
    img, rays = mk.render_image_kernel(scene, cam, **kw)
    assert_compare(ref, ref_rays, img.numpy(), rays)


def test_sample_offset_changes_noise():
    scene, cam = port_of(j_two(), two_spheres_cam())
    a, _ = mk.render_image_kernel(scene, cam, 64, 32, spp=1, max_bounces=3, seed=5)
    b, _ = mk.render_image_kernel(scene, cam, 64, 32, spp=1, max_bounces=3, seed=5, sample_offset=1)
    assert float((a - b).abs().max()) > 1e-4
    c, _ = mk.render_image_kernel(scene, cam, 64, 32, spp=1, max_bounces=3, seed=5)
    assert torch.equal(a, c)  # deterministic


def test_launch_count_stays_zero_on_cpu():
    scene, cam = port_of(j_rtiow(grid=2), rtiow_cam())
    before = (mk.LAUNCHES, dict(mk.LAUNCHES_BY_MODE))
    mk.render_image_kernel(scene, cam, 16, 8, spp=1, max_bounces=2)
    mk.render_image_kernel(mk.pack_scene(scene, worklist=False), cam, 16, 8, spp=1, max_bounces=2)
    assert (mk.LAUNCHES, dict(mk.LAUNCHES_BY_MODE)) == before


def test_cuda_request_without_cuda_raises():
    """Asking for the kernel (scene and camera on "cuda") where CUDA is
    absent raises; nothing falls back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be served")
    scene, cam = port_of(j_two(), two_spheres_cam())
    before = mk.LAUNCHES
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        mk.render_image_kernel(scene.to("cuda"), cam.to("cuda"), 16, 8)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        mk.render_image_kernel(mk.pack_scene(scene).to("cuda"), cam, 16, 8)
    assert mk.LAUNCHES == before


def test_non_cpu_non_cuda_tensors_raise():
    """Only CPU tensors take the plain version; anything else must launch."""
    scene, cam = port_of(j_two(), two_spheres_cam())
    with pytest.raises(ValueError, match="CUDA tensors"):
        mk.render_image_kernel(mk.pack_scene(scene).to("meta"), cam.to("meta"), 16, 8)


def test_unported_options_raise():
    scene, cam = port_of(j_two(), two_spheres_cam())
    # NEE is ported; a scene without an emissive sphere has nothing to sample
    with pytest.raises(ValueError, match="emissive"):
        mk.render_image_kernel(scene, cam, 16, 8, nee=True)
    with pytest.raises(ValueError, match="griddable"):
        mk.render_image_kernel(scene, cam, 16, 8, worklist=True)
    with pytest.raises(ValueError, match="sky"):
        mk.render_image_kernel(scene, cam, 16, 8, sky="sunset")
