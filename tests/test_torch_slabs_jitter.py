"""Row slabs and pixel-centre rays, on the CPU (ROADMAP C-3 and C-4).

- ``rows=``/``row_offset=`` on the three kernel wrappers and their plain
  versions render the full-width slab of rows [row_offset, row_offset +
  rows) of the frame: on the CPU the plain versions go through
  ``integrator.render_tile``'s global offsets, so each slab is the full
  frame's rows bit for bit and the slabs' rays sum to the frame's. The
  sphere wrapper's slab is held to the JAX package's
  ``render_image_pallas(rows=, row_offset=, interpret=True)`` with the
  bounds of tests/test_kernels.py::compare, as the megakernel parity
  tests hold full frames.
- ``jitter=False`` takes each camera ray through the pixel centre, as JAX's
  ``render_image(jitter=False)`` does; ``PathTraceRenderer`` passes
  ``RenderConfig.jitter`` to the plain versions on the CPU and refuses it
  only where a CUDA kernel would run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.app.renderers import PathTraceRenderer as JPathTraceRenderer
from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels import render_image_pallas
from csgrenderer_tpu.models import two_spheres_scene as j_two
from csgrenderer_tpu.render import render_image as j_render
from csgrenderer_tpu.render.integrator import SphereScene as JSphereScene
from csgrenderer_tpu.utils.config import RenderConfig as JRenderConfig
from csgrenderer_tpu_torch.app import PathTraceRenderer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import (
    config3_csg_scene,
    csg_night_scene,
    mesh_demo_scene,
    two_spheres_scene,
)
from csgrenderer_tpu_torch.render import integrator
from csgrenderer_tpu_torch.render.integrator import SphereScene
from csgrenderer_tpu_torch.utils.config import RenderConfig

from test_torch_megakernel import assert_compare, port_of, two_spheres_cam


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cam(eye, at, vfov, aspect=2.0):
    return Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect)


SLAB_CASES = {
    "sphere-brute": (mk.render_image_kernel, mk.render_image_plain,
                     lambda: mk.pack_scene(two_spheres_scene()),
                     lambda: _cam((0, 0, 0), (0, 0, -1), 90.0), dict(max_bounces=3, seed=4)),
    "tape-clustered-nee": (tk.render_image_tape_kernel, tk.render_image_tape_plain,
                           lambda: tk.pack_program(csg_night_scene().compile(k=4)),
                           lambda: _cam((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), 38.0),
                           dict(max_bounces=3, seed=1, sky="black", nee=True)),
    "mesh-grid": (tm.render_image_mesh_kernel, tm.render_image_mesh_plain,
                  lambda: tm.pack_mesh(mesh_demo_scene(2)),
                  lambda: _cam((0.0, 1.6, 2.2), (0.0, 0.7, -2.6), 45.0),
                  dict(max_bounces=3, seed=2)),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slabs_are_the_frames_rows(case):
    """Slabs of 3, 7 and 6 rows of a 16x16, 2-spp frame, through the
    wrapper and through the plain version: the frame's rows bit for bit;
    the slabs' rays sum to the frame's."""
    wrapper, plain, pack, camera, kw = SLAB_CASES[case]
    packed, cam = pack(), camera()
    assert packed.device.type == "cpu"
    full, rays = wrapper(packed, cam, 16, 16, spp=2, **kw)
    for fn in (wrapper, plain):
        parts, total = [], 0
        for offset, rows in ((0, 3), (3, 7), (10, 6)):
            img, r = fn(packed, cam, 16, 16, spp=2, rows=rows, row_offset=offset, **kw)
            assert img.shape == (rows, 16, 3)
            parts.append(img)
            total += int(r)
        assert torch.equal(torch.cat(parts), full)
        assert total == int(rays)
    for rows, offset in ((0, 0), (17, 0), (4, 13), (2, -1)):
        with pytest.raises(ValueError, match="slab"):
            wrapper(packed, cam, 16, 16, rows=rows, row_offset=offset, **kw)


def test_sphere_slab_matches_jax_interpret():
    """The sphere wrapper's slab (rows 3-7 of a 16x8 frame, 1 spp, 2
    bounces, two spheres) against JAX's interpret-mode kernel's slab."""
    jscene, jcam = j_two(), two_spheres_cam()
    kw = dict(spp=1, max_bounces=2, seed=3)
    ref, ref_rays = render_image_pallas(jscene, jcam, 16, 8, rows=5, row_offset=3,
                                        interpret=True, **kw)
    scene, cam = port_of(jscene, jcam)
    img, rays = mk.render_image_kernel(scene, cam, 16, 8, rows=5, row_offset=3, **kw)
    assert img.shape == (5, 16, 3) and np.asarray(ref).shape == (5, 16, 3)
    assert_compare(np.asarray(ref), ref_rays, img.numpy(), rays)
    full, _ = mk.render_image_kernel(scene, cam, 16, 8, **kw)
    assert torch.equal(full[3:8], img)


# --- C-3: jitter=False ----------------------------------------------------------


def test_single_emissive_sphere_black_sky():
    """tests/test_integrator.py::test_single_emissive_sphere_black_sky on
    the port: the centre pixel's ray through the pixel centre sees the
    lamp, a corner's sees the black sky."""
    scene = SphereScene(
        centers=torch.tensor([[0.0, 0.0, -3.0]]), radii=torch.tensor([1.0]),
        mat_kind=torch.tensor([4], dtype=torch.int32), albedo=torch.tensor([[2.0, 1.0, 0.5]]),
        mat_param=torch.tensor([0.0]))
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=60, aspect_ratio=1.0)
    img, _ = integrator.render_image(scene.nearest_hit, cam, 33, 33, spp=1, max_bounces=3,
                                     seed=0, sky="black", jitter=False)
    np.testing.assert_allclose(img[16, 16].numpy(), [2.0, 1.0, 0.5], atol=1e-5)
    np.testing.assert_allclose(img[0, 0].numpy(), [0.0, 0.0, 0.0], atol=1e-6)


def test_pixel_centres_match_jax():
    """A jitter=False frame (two spheres, 24x12, 2 spp, lens on, so the
    lens sample still varies) against JAX's render_image(jitter=False) on
    the same inputs, run op by op; and it differs from the jittered one."""
    jscene, jcam = j_two(), JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90,
                                            aspect_ratio=2.0, aperture=0.2, focus_dist=1.0)
    kw = dict(spp=2, max_bounces=4, seed=9, lens=True)
    with jax.disable_jit():
        ref, ref_rays = j_render(jscene.nearest_hit, jcam, 24, 12, jitter=False, **kw)
    scene, cam = port_of(jscene, jcam)
    img, rays = mk.render_image_plain(mk.pack_scene(scene), cam, 24, 12, jitter=False, **kw)
    assert_compare(np.asarray(ref), ref_rays, img.numpy(), rays)
    jittered, _ = mk.render_image_plain(mk.pack_scene(scene), cam, 24, 12, **kw)
    assert not torch.equal(img, jittered)


def test_renderer_passes_jitter_on_the_cpu_and_refuses_it_on_cuda():
    """PathTraceRenderer(RenderConfig(jitter=False), device="cpu") renders
    pixel centres, as the JAX package's jnp renderer does; on "cuda" the
    request is refused (the kernels always jitter), naming device="cpu"."""
    cfg = dict(width=24, height=12, spp=2, max_bounces=4, seed=5, jitter=False)
    jcam = JCamera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    with jax.disable_jit():
        ref = np.asarray(JPathTraceRenderer(j_two(), jcam, JRenderConfig(**cfg),
                                            backend="jnp").draw_frame(0.0))
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=2.0)
    got = PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(**cfg),
                            device="cpu").draw_frame(0.0).numpy()
    assert got.shape == ref.shape and (np.abs(got.astype(int) - ref.astype(int)) > 1).mean() < 0.01
    for wrapper, scene in ((mk.render_image_kernel, mk.pack_scene(two_spheres_scene())),
                           (tk.render_image_tape_kernel,
                            tk.pack_program(config3_csg_scene().compile(k=2))),
                           (tm.render_image_mesh_kernel, tm.pack_mesh(mesh_demo_scene(1)))):
        with pytest.raises(NotImplementedError, match="jitters"):
            wrapper(scene.to("meta"), cam.to("meta"), 8, 4, jitter=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(**cfg))
    else:
        with pytest.raises(NotImplementedError, match="device='cpu'"):
            PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(**cfg), device="cuda")


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_sample_batch_gives_the_same_bits(case):
    """The plain versions trace ``sample_batch`` samples as one batch of
    rays (validate_gpu's reference does, at ~2 M rays a pass) and still sum
    them one after another: the image and the rays do not depend on it."""
    _, plain, pack, camera, kw = SLAB_CASES[case]
    packed, cam = pack(), camera()
    one, rays = plain(packed, cam, 12, 8, spp=5, sample_offset=3, **kw)
    for batch in (2, 5, 8):
        img, r = plain(packed, cam, 12, 8, spp=5, sample_offset=3, sample_batch=batch, **kw)
        assert torch.equal(img, one) and int(r) == int(rays)
    with pytest.raises(ValueError, match="sample_batch"):
        plain(packed, cam, 12, 8, spp=2, sample_batch=0, **kw)
