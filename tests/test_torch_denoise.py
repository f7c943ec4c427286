"""The port's AOV pass (render/aov.py) and a-trous denoiser
(render/denoise.py) on the CPU: tests/test_denoise.py's ten tests on the
port, and the port against the JAX package on the same inputs.

Tolerances against JAX: ``render_aovs`` hit equal, depth, normal and
albedo within 1e-5 (measured 4.8e-7, 0 and 6.0e-8 on two_spheres at
96x54); ``atrous_denoise`` within 1e-5 (measured 6.0e-7 on the random
colour below: torch's and XLA's CPU ``exp``/``pow`` differ in the last
ulp); ``PathTraceRenderer(denoise=True)`` at test_torch_app.py's bound for
the undenoised frame, at most one pixel off by more than 1 in 255.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.app.renderers import PathTraceRenderer as JPathTraceRenderer
from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.models import two_spheres_scene as j_two_spheres
from csgrenderer_tpu.render import atrous_denoise as j_atrous_denoise
from csgrenderer_tpu.render import render_aovs as j_render_aovs
from csgrenderer_tpu.utils.config import RenderConfig as JRenderConfig
from csgrenderer_tpu_torch.app.renderers import PathTraceRenderer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import atrous
from csgrenderer_tpu_torch.models import animated_csg_scene, two_spheres_scene
from csgrenderer_tpu_torch.render import (
    AOVs,
    atrous_denoise,
    denoise,
    denoise_frame,
    render_aovs,
    render_image,
)
from csgrenderer_tpu_torch.render.trimesh import icosphere
from csgrenderer_tpu_torch.scene import Material
from csgrenderer_tpu_torch.utils.config import RenderConfig

W, H = 96, 54


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def diffuse_setup():
    scene = two_spheres_scene()
    camera = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=W / H)
    return scene, camera


def _jax_setup():
    return j_two_spheres(), JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0,
                                            aspect_ratio=W / H)


def test_aovs_shapes_and_alignment(diffuse_setup):
    scene, camera = diffuse_setup
    aovs = render_aovs(scene.nearest_hit, camera, W, H)
    assert aovs.depth.shape == (H, W) and aovs.normal.shape == (H, W, 3)
    assert aovs.albedo.shape == (H, W, 3) and aovs.hit.shape == (H, W)
    assert aovs.hit.dtype == torch.bool and aovs.depth.dtype == torch.float32

    # centre pixel: the small sphere at (0, 0, -1), a hit with a unit
    # normal facing the camera (+z) at finite positive depth
    cy, cx = H // 2, W // 2
    assert bool(aovs.hit[cy, cx])
    assert float(aovs.depth[cy, cx]) == pytest.approx(0.5, abs=0.05)
    n = aovs.normal[cy, cx].numpy()
    assert np.linalg.norm(n) == pytest.approx(1.0, abs=1e-4)
    assert n[2] > 0.9

    # top-left pixel: sky, a miss with inf depth, zero normal, sky albedo
    assert not bool(aovs.hit[0, 0])
    assert not np.isfinite(float(aovs.depth[0, 0]))
    assert np.allclose(aovs.normal[0, 0].numpy(), 0.0)
    alb = aovs.albedo[0, 0].numpy()
    assert alb[2] >= alb[0]  # the sky gradient is blue at the top


def test_render_aovs_matches_jax(diffuse_setup):
    scene, camera = diffuse_setup
    js, jc = _jax_setup()
    got = render_aovs(scene.nearest_hit, camera, W, H)
    ref = j_render_aovs(js.nearest_hit, jc, W, H)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.isfinite(got.depth.numpy()), np.isfinite(np.asarray(ref.depth)))
    hit = got.hit.numpy()
    np.testing.assert_allclose(got.depth.numpy()[hit], np.asarray(ref.depth)[hit], rtol=0,
                               atol=1e-5)
    for name in ("normal", "albedo"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("demodulate", [True, False])
def test_atrous_denoise_matches_jax(diffuse_setup, demodulate):
    """The same colour (numpy, seeded) and AOVs through both filters."""
    scene, camera = diffuse_setup
    js, jc = _jax_setup()
    color = np.random.default_rng(0).random((H, W, 3), dtype=np.float32) * 2.0
    got = atrous_denoise(torch.from_numpy(color), render_aovs(scene.nearest_hit, camera, W, H),
                         demodulate=demodulate)
    ref = j_atrous_denoise(jnp.asarray(color), j_render_aovs(js.nearest_hit, jc, W, H),
                           demodulate=demodulate)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_denoise_reduces_noise_vs_reference(diffuse_setup):
    scene, camera = diffuse_setup
    noisy, _ = render_image(scene.nearest_hit, camera, W, H, spp=2, max_bounces=4, seed=0)
    ref, _ = render_image(scene.nearest_hit, camera, W, H, spp=256, max_bounces=4, seed=1)
    den = atrous_denoise(noisy, render_aovs(scene.nearest_hit, camera, W, H))
    rmse_noisy = float(torch.sqrt(torch.mean((noisy - ref) ** 2)))
    rmse_den = float(torch.sqrt(torch.mean((den - ref) ** 2)))
    # the filter must cut at least 40% of the 2-spp error
    assert rmse_den < 0.6 * rmse_noisy
    assert bool(torch.isfinite(den).all())


def test_denoise_frame_convenience_matches_manual(diffuse_setup):
    scene, camera = diffuse_setup
    noisy, _ = render_image(scene.nearest_hit, camera, W, H, spp=2, max_bounces=3, seed=0)
    a = denoise_frame(noisy, scene.nearest_hit, camera, iterations=2)
    b = atrous_denoise(noisy, render_aovs(scene.nearest_hit, camera, W, H), iterations=2)
    assert torch.equal(a, b)


def _synthetic_edge(h=32, w=32, noise=0.15, seed=0):
    """Two flat regions split at w // 2 by a joint normal and depth edge."""
    rng = np.random.default_rng(seed)
    left = np.zeros((h, w), bool)
    left[:, : w // 2] = True
    color = np.repeat(np.where(left[..., None], 0.2, 0.8), 3, axis=-1).astype(np.float32)
    noisy = color + rng.normal(0.0, noise, color.shape).astype(np.float32)
    normal = np.where(left[..., None], np.array([0, 0, 1.0]),
                      np.array([1.0, 0, 0])).astype(np.float32)
    depth = np.where(left, 1.0, 2.0).astype(np.float32)
    aovs = AOVs(depth=torch.from_numpy(depth), normal=torch.from_numpy(normal),
                albedo=torch.ones((h, w, 3)), hit=torch.ones((h, w), dtype=torch.bool))
    return torch.from_numpy(noisy), torch.from_numpy(color), aovs, left


def test_denoise_smooths_flat_regions_without_edge_bleed():
    noisy, clean, aovs, _ = _synthetic_edge()
    den = atrous_denoise(noisy, aovs, iterations=3).numpy()
    # noise inside each region drops by more than 3x
    err_in = np.abs(noisy.numpy() - clean.numpy())
    err_out = np.abs(den - clean.numpy())
    assert err_out.mean() < err_in.mean() / 3.0
    # the step across the edge survives: the region means stay apart
    half = den.shape[1] // 2
    assert den[:, :half].mean() == pytest.approx(0.2, abs=0.05)
    assert den[:, half:].mean() == pytest.approx(0.8, abs=0.05)
    # the two pixel columns flanking the edge keep more than 80% of the step
    assert den[:, half].mean() - den[:, half - 1].mean() > 0.8 * 0.6


def test_denoise_hit_gate_blocks_sky_bleed():
    noisy, clean, aovs, _ = _synthetic_edge(noise=0.0)
    # the right half becomes sky: hit False, depth inf (the AOV contract)
    hit = aovs.hit.clone()
    hit[:, hit.shape[1] // 2:] = False
    depth = aovs.depth.clone()
    depth[:, hit.shape[1] // 2:] = float("inf")
    den = atrous_denoise(noisy, aovs._replace(hit=hit, depth=depth), iterations=3)
    # noiseless input and a hard hit gate: both regions are kept exactly
    np.testing.assert_allclose(den.numpy(), clean.numpy(), atol=1e-5)


def test_denoise_is_pure():
    """The port's twin of test_denoise_is_jit_pure: torch runs eagerly, so
    what must hold is that the filter leaves its inputs as they were and
    gives the same bytes on a second call."""
    noisy, _, aovs, _ = _synthetic_edge()
    inputs = [noisy.clone(), *(x.clone() for x in aovs)]
    first = atrous_denoise(noisy, aovs, iterations=2)
    second = atrous_denoise(noisy, aovs, iterations=2)
    assert torch.equal(first, second)
    for before, after in zip(inputs, [noisy, *aovs]):
        assert torch.equal(before, after)


def test_aov_row_chunking_matches_unchunked(diffuse_setup):
    scene, camera = diffuse_setup
    full = render_aovs(scene.nearest_hit, camera, W, H)
    # 7 does not divide H = 54: the largest divisor <= 7, 6, is used
    chunked = render_aovs(scene.nearest_hit, camera, W, H, row_chunk=7)
    for a, b in zip(full, chunked):  # the same operations per row: equal
        assert torch.equal(a, b)


def test_mesh_face_chunking_matches_unchunked():
    mesh = icosphere((0, 0, -2), 0.8, Material.lambertian((0.6, 0.3, 0.2)),
                     subdivisions=2)  # 320 faces
    camera = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=60.0, aspect_ratio=1.0)
    full = render_aovs(mesh.nearest_hit, camera, 32, 32)
    chunked = render_aovs(lambda o, d: mesh.nearest_hit(o, d, face_chunk=48), camera, 32, 32,
                          row_chunk=8)
    assert torch.equal(full.hit, chunked.hit)
    for a, b in zip(full[:3], chunked[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)


def test_renderer_denoise_wiring_improves_rmse(diffuse_setup):
    """PathTraceRenderer(denoise=True) beats the raw frame against a
    converged reference: the production wiring, not the bare filter."""
    scene, camera = diffuse_setup
    base = dict(width=W, height=H, spp=2, max_bounces=4, seed=0)
    raw_r = PathTraceRenderer(scene, camera, RenderConfig(**base), device="cpu")
    den_r = PathTraceRenderer(scene, camera, RenderConfig(**base, denoise=True), device="cpu")
    ref, _ = render_image(scene.nearest_hit, camera, W, H, spp=256, max_bounces=4, seed=1)
    ref8 = raw_r._tonemap(ref).numpy().astype(np.float32)
    raw = raw_r.draw_frame(0.0).numpy().astype(np.float32)
    den = den_r.draw_frame(0.0).numpy().astype(np.float32)
    rmse_raw = np.sqrt(np.mean((raw - ref8) ** 2))
    rmse_den = np.sqrt(np.mean((den - ref8) ** 2))
    assert rmse_den < 0.6 * rmse_raw
    # the asynchronous path gives the same denoised frame
    img_async, _ = den_r.draw_frame_async(0.0)
    np.testing.assert_array_equal(img_async.numpy(), den.astype(np.uint8))


def test_renderer_denoise_matches_jax():
    """PathTraceRenderer(device="cpu", denoise=True) against the JAX
    package's jnp renderer with the same config."""
    cfg = dict(width=48, height=24, spp=2, max_bounces=3, seed=1, denoise=True,
               denoise_iterations=3)
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    jcam = JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    got = PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(**cfg),
                            device="cpu").draw_frame(0.0).numpy()
    ref = np.asarray(JPathTraceRenderer(j_two_spheres(), jcam, JRenderConfig(**cfg),
                                        backend="jnp").draw_frame(0.0))
    assert (np.abs(got.astype(int) - ref.astype(int)).max(axis=-1) > 1).sum() <= 1


def test_renderer_denoise_animated_tape():
    """An animated CompiledTape denoises against the frame-time geometry
    (the denoise step applies ``animate`` to the scene again)."""
    graph, animate = animated_csg_scene(3)
    cam = Camera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40.0, aspect_ratio=1.5)
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=3, denoise=True,
                       denoise_iterations=2)
    r = PathTraceRenderer(graph.compile(), cam, cfg, animate=animate, device="cpu")
    f0 = r.draw_frame(0.0).numpy()
    f1 = r.draw_frame(1.0).numpy()
    assert f0.shape == (32, 48, 3)
    assert not np.array_equal(f0, f1)  # the geometry (and its AOVs) moved
    undenoised = PathTraceRenderer(graph.compile(), cam, dataclasses.replace(cfg, denoise=False),
                                   animate=animate, device="cpu").draw_frame(0.0).numpy()
    assert not np.array_equal(f0, undenoised)


def test_cpu_denoise_runs_the_plain_version_and_the_kernel_wants_cuda():
    """On CPU tensors the filter is the plain version (no kernel launch);
    the kernel's wrapper refuses CPU tensors rather than falling back."""
    noisy, _, aovs, _ = _synthetic_edge()
    before = atrous.LAUNCHES
    assert torch.equal(atrous_denoise(noisy, aovs, iterations=2),
                       denoise.atrous_denoise_plain(noisy, aovs, iterations=2))
    assert atrous.LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        atrous.atrous_passes(noisy, aovs.normal, aovs.depth, aovs.hit, [(1, 0.25, 44.4)], 32.0)
    assert torch.equal(atrous_denoise(noisy, aovs, iterations=0), noisy)
