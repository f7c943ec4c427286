"""The sphere kernel's G-buffer mode (``megakernel.render_aovs_kernel``) on
the CPU: its plain version against the JAX package's AOV cast, the
wrapper's refusal of CPU tensors, and the renderer's choice of cast.

The plain version casts through the packed scene's plain hit function: in
grid mode the globals and the xz-grid walk, where JAX's cast is brute force
over every sphere. It is held to JAX's ``render_aovs`` through JAX's hit
function with the kernels' float grouping (each product of the sphere
test's dot products rounded, as tests/test_torch_golden_config4.py writes
it out): at most 0.2% of pixels may differ (the render kernels' band
against brute is 0.0004-0.154%); on every other pixel hit is equal and
depth, normal and albedo are within 1e-5. JAX's own hit function forms
d.c and o.c with XLA's CPU dot, a chain of fused multiply-adds (ROADMAP
C-5), which moves t at sphere silhouettes: against it the hit mask and the
albedo still agree (hit on all but 0.2% of pixels, albedo within 1e-5),
depth within 1e-3 relative and normals within 1e-2 (measured 1.6e-4 and
5.2e-3 on the RTIOW final scene at 64x36).
"""

import dataclasses

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
from csgrenderer_tpu.models import two_spheres_scene as j_two
from csgrenderer_tpu.render import render_aovs as j_render_aovs
from csgrenderer_tpu_torch.app.renderers import PathTraceRenderer, hit_fn_for
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene
from csgrenderer_tpu_torch.render import atrous_denoise, render_aovs
from csgrenderer_tpu_torch.utils.config import RenderConfig

from test_torch_golden_config4 import _kernel_grouping_hit

W, H = 64, 36
SHARE = 2e-3  # most pixels that may differ from the JAX cast
TOL = 1e-5

SCENES = {  # name -> (port scene, JAX scene, camera arguments, expected mode)
    "rtiow": (rtiow_final_scene, j_rtiow,
              dict(lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0), vfov_degrees=20.0,
                   aperture=0.1, focus_dist=10.0), "grid"),
    "two_spheres": (two_spheres_scene, j_two,
                    dict(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), vfov_degrees=90.0),
                    "brute"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cameras(kw):
    kw = dict(kw, aspect_ratio=W / H)
    eye, at = kw.pop("lookfrom"), kw.pop("lookat")
    return Camera.look_at(eye, at, **kw), JCamera.look_at(eye, at, **kw)


def _differ(got, ref, tols):
    """[H, W] bool: pixels whose hit differs, or where a field is off by
    more than its (rtol, atol) in ``tols`` (two infinite depths agree)."""
    differ = got.hit.numpy() != np.asarray(ref.hit)
    for field, (rtol, atol) in tols.items():
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        close = np.isclose(a, b, rtol=rtol, atol=atol) | (np.isinf(a) & np.isinf(b))
        differ |= ~close.reshape(H, W, -1).all(axis=-1)
    return differ


@pytest.mark.parametrize("sky", ["rtiow", "wololo", "black"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_gbuffer_plain_matches_jax(name, sky):
    """The G-buffer mode's plain version (the grid walk on the RTIOW final
    scene, brute force on two spheres) against JAX's ``render_aovs``
    through the kernels' float grouping."""
    make, make_j, cam_kw, mode = SCENES[name]
    packed = mk.pack_scene(make())
    assert packed.mode == mode
    cam, jcam = _cameras(cam_kw)
    got = mk.render_aovs_plain(packed, cam, W, H, sky=sky)
    ref = j_render_aovs(_kernel_grouping_hit(make_j()), jcam, W, H, sky=sky)
    differ = _differ(got, ref, {f: (0.0, TOL) for f in ("depth", "normal", "albedo")})
    assert differ.mean() <= SHARE, differ.mean()
    assert np.asarray(ref.hit).any() and not np.asarray(ref.hit).all()  # hits and sky


def test_gbuffer_plain_against_jax_own_cast():
    """The same on the RTIOW final scene against JAX's cast as it ships
    (XLA's fused dot in the sphere test): the bounds of the docstring."""
    make, make_j, cam_kw, _ = SCENES["rtiow"]
    cam, jcam = _cameras(cam_kw)
    got = mk.render_aovs_plain(mk.pack_scene(make()), cam, W, H)
    ref = j_render_aovs(make_j().nearest_hit, jcam, W, H)
    assert (got.hit.numpy() != np.asarray(ref.hit)).mean() <= SHARE
    differ = _differ(got, ref, {"depth": (1e-3, 0.0), "normal": (0.0, 1e-2),
                                "albedo": (0.0, TOL)})
    assert differ.mean() <= SHARE, differ.mean()


def test_gbuffer_plain_is_render_aovs_through_the_plain_hit_function():
    """In brute mode the plain version is ``render_aovs`` with the scene's
    own hit function, byte for byte."""
    packed = mk.pack_scene(two_spheres_scene())
    cam, _ = _cameras(SCENES["two_spheres"][2])
    got = mk.render_aovs_plain(packed, cam, W, H)
    ref = render_aovs(packed.scene.nearest_hit, cam, W, H)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_gbuffer_kernel_needs_cuda_tensors():
    packed = mk.pack_scene(two_spheres_scene())
    cam, _ = _cameras(SCENES["two_spheres"][2])
    before = dict(mk.LAUNCHES_BY_MODE)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mk.render_aovs_kernel(packed, cam, W, H)
    with pytest.raises(ValueError, match="unknown sky mode"):
        mk.render_aovs_kernel(packed, cam, W, H, sky="dusk")
    assert mk.LAUNCHES_BY_MODE == before


def test_cpu_denoise_casts_through_the_plain_hit_function(monkeypatch):
    """On the CPU a sphere frame's AOVs come from ``render_aovs`` through
    the scene's plain hit function, as before; the kernel is never asked."""
    def refuse(*a, **k):
        raise AssertionError("the G-buffer kernel was asked on the CPU")

    monkeypatch.setattr(mk, "render_aovs_kernel", refuse)
    scene = two_spheres_scene()
    cam, _ = _cameras(SCENES["two_spheres"][2])
    cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=3, denoise=True,
                       denoise_iterations=2)
    r = PathTraceRenderer(scene, cam, cfg, device="cpu")
    radiance, _ = r._render(0.0)
    ref = atrous_denoise(radiance, render_aovs(hit_fn_for(scene), cam, W, H), iterations=2)
    assert torch.equal(r.denoise_image(radiance, 0.0), ref)
    raw = PathTraceRenderer(scene, cam, dataclasses.replace(cfg, denoise=False), device="cpu")
    assert torch.equal(raw.denoise_image(radiance, 0.0), radiance)


def test_animated_sphere_frame_is_packed_once(monkeypatch):
    """An animated sphere scene is packed once a frame, by ``_render``, and
    the denoise step's cast takes that pack for the same time."""
    packs = []
    real = mk.pack_scene

    def counting(scene, *a, **k):
        packs.append(scene)
        return real(scene, *a, **k)

    monkeypatch.setattr(mk, "pack_scene", counting)

    def animate(scene, t):
        return dataclasses.replace(scene, centers=scene.centers + torch.tensor([0.0, t, 0.0]))

    cam, _ = _cameras(SCENES["two_spheres"][2])
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2, denoise=True,
                       denoise_iterations=1)
    r = PathTraceRenderer(two_spheres_scene(), cam, cfg, animate=animate, device="cpu")
    assert not packs  # animated: nothing packed at construction
    r.draw_frame(0.25)
    assert len(packs) == 1
    assert r._sphere_pack(0.25) is r._frame_pack[1] and len(packs) == 1
    assert float(r._frame_pack[1].scene.centers[0, 1]) == pytest.approx(0.25)
    r._sphere_pack(0.5)  # a time no frame was rendered at: packed anew
    assert len(packs) == 2
