"""The port's multi-device path on the CPU: tests/test_parallel.py's mirror.

One world of 8 gloo ranks (``parallel.launch.run_ranks``, one process per
rank, spawned once for the module) runs every sharded render below; the
parent holds the results against the port's unsharded renders and against
the JAX package's sharded renders on the conftest's 8-device CPU mesh.
The rank workers import nothing of JAX (this file's top level imports
none): the JAX references are computed in the parent.

Tolerances:
- against the port's own unsharded image: bit for bit where the sample
  axis is 1 (the counter-based RNG and the slabs' global row offsets make
  any tiling the same image), within atol 1e-5 elsewhere (the samples sum
  in another order), with the rays equal;
- against JAX: as tests/test_parallel.py holds each case, but where the
  port and JAX differ before any sharding, a cross-framework silhouette
  flip (XLA's fused arithmetic, the bounds of tests/test_kernels.py::compare,
  which the port's unsharded renders are held to in
  tests/test_torch_megakernel.py): pixels where the unsharded renders of
  the two packages agree within 1e-5 must agree within 1e-5 sharded too.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.app import PathTraceRenderer
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import shard_canary as sc
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import config3_csg_scene, rtiow_final_scene, two_spheres_scene
from csgrenderer_tpu_torch.parallel import (
    gather_rows,
    make_mesh,
    render_image_sharded,
    render_scene_sharded,
    render_to_noise_sharded,
    single_device_mesh,
)
from csgrenderer_tpu_torch.parallel.launch import run_ranks
from csgrenderer_tpu_torch.render import integrator
from csgrenderer_tpu_torch.render.trimesh import concat_meshes, icosphere, quad
from csgrenderer_tpu_torch.scene import Material
from csgrenderer_tpu_torch.scene.tape import CompiledTape
from csgrenderer_tpu_torch.utils.config import RenderConfig

WORLD = 8
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]
IMAGE_KW = dict(spp=8, max_bounces=4, seed=9)  # tests/test_parallel.py's setup frame, 64x32
NOISE_KW = dict(target=5e-3, max_spp=64, spp_chunk=4, max_bounces=4, seed=9)


def _diffuse_cam(aspect=2.0, lib=None):
    return (lib or Camera).look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=aspect)


# name -> (scene maker (port or JAX modules), camera (eye, at, vfov, aspect, lens kw), frame)
def _scene_cases(lib):
    """The scenes of render_scene_sharded's branches, built from ``lib``
    (this package's modules, or the JAX package's, so each side builds its
    own): sphere brute, sphere grid, tape, mesh, mesh with NEE (the lamp
    scene of __graft_entry__.dryrun_multichip)."""
    mat = lib["Material"]
    rtiow_cam = ((13, 2, 3), (0, 0, 0), 20.0, 2.0, dict(aperture=0.1, focus_dist=10.0))
    return {
        "sphere-brute": (lib["two_spheres_scene"], ((0, 0, 0), (0, 0, -1), 90.0, 2.0, {}),
                         dict(width=64, height=32, spp=8, max_bounces=4, seed=9)),
        "sphere-grid": (lib["rtiow_final_scene"], rtiow_cam,
                        dict(width=64, height=32, spp=2, max_bounces=4, seed=0, lens=True)),
        "tape": (lambda: lib["config3_csg_scene"]().compile(k=2),
                 ((3, 2.5, 4), (0.1, 0, 0), 35.0, 1.0, {}),
                 dict(width=32, height=32, spp=2, max_bounces=3, seed=3)),
        "mesh": (lambda: lib["icosphere"]((0, 0, -4), 1.0, mat.lambertian((0.6, 0.3, 0.3)), 1),
                 ((0, 0, 0), (0, 0, -4), 45.0, 2.0, {}),
                 dict(width=64, height=32, spp=2, max_bounces=3, seed=5)),
        "mesh-nee": (lambda: lib["concat_meshes"](
            lib["icosphere"]((0, 0.6, -4), 1.0, mat.lambertian((0.6, 0.3, 0.3)), 2),
            lib["quad"]((-1, 2.4, -4.6), (1, 2.4, -4.6), (1, 2.4, -3.2), (-1, 2.4, -3.2),
                        mat.emissive((10.0, 9.0, 7.0)))),
            ((0, 1.2, 0), (0, 0.6, -4), 45.0, 2.0, {}),
            dict(width=64, height=32, spp=2, max_bounces=3, seed=5, sky="black", nee=True)),
    }


PORT = dict(Material=Material, two_spheres_scene=two_spheres_scene,
            rtiow_final_scene=rtiow_final_scene, config3_csg_scene=config3_csg_scene,
            icosphere=icosphere, concat_meshes=concat_meshes, quad=quad)


def _camera(spec, lib=Camera):
    eye, at, vfov, aspect, extra = spec
    return lib.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=aspect, **extra)


def _kernel_render(scene, cam, **kw):
    """The port's unsharded kernel wrapper of the scene's type."""
    if isinstance(scene, integrator.SphereScene):
        return mk.render_image_kernel(scene, cam, **kw)
    if isinstance(scene, CompiledTape):
        return tk.render_image_tape_kernel(scene, cam, **kw)
    return tm.render_image_mesh_kernel(scene, cam, **kw)


def world_worker():
    """One rank of the 8-rank world: every sharded render of this file.
    Rank 0 returns the gathered frames; every rank returns what it must
    agree on with the others (noise, spp used, rays, canary checks)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank}

    # mesh validation (tests/test_parallel.py::test_mesh_validation)
    try:
        make_mesh(3, 3, device="cpu")
    except ValueError as e:
        out["mesh_3x3"] = str(e)
    mesh42 = make_mesh(4, 2, device="cpu")
    out["shape_4x2"] = mesh42.shape
    scene, cam = two_spheres_scene(), _diffuse_cam()
    for name, h, spp in (("height_30", 30, 4), ("spp_3", 32, 3)):
        try:
            render_image_sharded(scene.nearest_hit, cam, 64, h, mesh42, spp=spp)
        except ValueError as e:
            out[name] = str(e)

    # the plain path at every mesh shape
    for t, s in SHAPES:
        mesh = make_mesh(t, s, ranks=range(t * s), device="cpu")
        if mesh.member:
            img, rays = render_image_sharded(scene.nearest_hit, cam, 64, 32, mesh, **IMAGE_KW)
            full = gather_rows(img, mesh)
            if rank == 0:
                out[("image", t, s)] = (full, int(rays))

    # the kernels' branches at 2x1 and 2x2 (their plain versions on the CPU)
    meshes = {(2, 1): make_mesh(2, 1, ranks=[0, 1], device="cpu"),
              (2, 2): make_mesh(2, 2, ranks=[0, 1, 2, 3], device="cpu")}
    for name, (make, cam_spec, frame) in _scene_cases(PORT).items():
        scene_i, cam_i = make(), _camera(cam_spec)
        for key, mesh in meshes.items():
            if mesh.member:
                img, rays = render_scene_sharded(scene_i, cam_i, mesh=mesh, **frame)
                full = gather_rows(img, mesh)
                if rank == 0:
                    out[("scene", name, key)] = (full, int(rays))

    # the canary in the 4 ranks of the 2x2 mesh: an input that varies with the tile index
    mesh = meshes[(2, 2)]
    if mesh.member:
        x = torch.ones(sc.SHAPE, dtype=torch.float32) + mesh.tile_index
        o = sc.scale2_kernel(x)
        out["canary_equal"] = (torch.equal(o, sc.scale2_plain(x)), torch.equal(o, torch.mul(x, 2.0)))
        gathered = gather_rows(o[None], mesh)
        if rank == 0:
            out["canary"] = gathered

    # render-to-noise at (4, 2): every rank must take the same stop decision
    acc, noise, used = render_to_noise_sharded(scene, cam, 64, 32, mesh42, device="cpu",
                                               **NOISE_KW)
    out["noise"] = (noise, used, acc.rays_traced, int(acc.sample_count))
    image = gather_rows(acc.image(), mesh42)
    if rank == 0:
        out["noise_image"] = image
    return out


@pytest.fixture(scope="module")
def world():
    return run_ranks(f"{__file__}:world_worker", WORLD, timeout=240,
                     env={"OMP_NUM_THREADS": "1"})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_image_refs():
    """JAX's render_image_sharded at every shape on the 8-device CPU mesh,
    and JAX's unsharded render_image, on tests/test_parallel.py's frame."""
    import jax

    from csgrenderer_tpu.camera import Camera as JCamera
    from csgrenderer_tpu.models import two_spheres_scene as j_two
    from csgrenderer_tpu.parallel import make_mesh as j_make_mesh
    from csgrenderer_tpu.parallel import render_image_sharded as j_sharded
    from csgrenderer_tpu.render import render_image as j_render

    assert len(jax.devices()) == WORLD, "conftest must force 8 CPU devices"
    scene, cam = j_two(), _diffuse_cam(lib=JCamera)
    img, rays = j_render(scene.nearest_hit, cam, 64, 32, **IMAGE_KW)
    refs = {"single": (np.asarray(img), int(rays))}
    for t, s in SHAPES:
        mesh = j_make_mesh(t, s, devices=jax.devices()[: t * s])
        img, rays = j_sharded(scene.nearest_hit, cam, 64, 32, mesh, **IMAGE_KW)
        refs[(t, s)] = (np.asarray(img), int(rays))
    return refs


def _assert_as_jax(img, rays, ref, ref_rays, port_single, jax_single):
    """The sharded port image against JAX's sharded one: the compare()
    bounds, and within atol 1e-5 wherever the two packages' unsharded
    images agree within 1e-5 (so sharding adds no difference of its own)."""
    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape
    assert float(np.sqrt(np.mean((img - ref) ** 2))) <= 2e-2
    assert float((np.abs(img - ref).max(axis=-1) > 0.05).mean()) <= 0.01
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)
    agree = np.abs(np.asarray(port_single) - np.asarray(jax_single)) <= 1e-5
    np.testing.assert_allclose(img[agree], ref[agree], atol=1e-5, rtol=0)


def _port_single(**kw):
    return integrator.render_image(two_spheres_scene().nearest_hit, _diffuse_cam(), 64, 32, **kw)


@pytest.mark.parametrize("tile,sample", SHAPES)
def test_sharded_matches_single_device(world, jax_image_refs, tile, sample):
    """render_image_sharded at (tile, sample) over 8 ranks: the port's
    render_image bit for bit at sample 1 (atol 1e-5 otherwise), rays equal;
    and JAX's render_image_sharded on the same mesh shape."""
    img, rays = world[0][("image", tile, sample)]
    ref, ref_rays = _port_single(**IMAGE_KW)
    assert img.shape == (32, 64, 3) and int(rays) == int(ref_rays)
    if sample == 1:
        assert torch.equal(img, ref)
    else:
        np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    j_img, j_rays = jax_image_refs[(tile, sample)]
    _assert_as_jax(img, rays, j_img, j_rays, ref, jax_image_refs["single"][0])


def test_mesh_validation(world):
    """tests/test_parallel.py::test_mesh_validation on 8 ranks, with JAX's
    words: no 3x3 mesh over 8 ranks, the 4x2 shape, and the divisibility
    errors; every rank raises alike (make_mesh checks before it makes any
    group, so no rank is left waiting)."""
    for res in world:
        assert res["mesh_3x3"] == "mesh 3x3 != 8 available devices"
        assert res["shape_4x2"] == {"tile": 4, "sample": 2}
        assert res["height_30"] == "height 30 not divisible by tile axis 4"
        assert res["spp_3"] == "spp 3 not divisible by sample axis 2"


def test_single_device_mesh_and_cuda_refusal(monkeypatch):
    """single_device_mesh() needs no process group: its render is the
    unsharded kernel wrapper's image bit for bit. device="cuda" on a host
    without CUDA raises, in make_mesh and in single_device_mesh alike."""
    mesh = single_device_mesh(device="cpu")
    assert mesh.shape == {"tile": 1, "sample": 1} and mesh.index == (0, 0)
    assert mesh.group is mesh.tile_group is mesh.sample_group is None
    scene, cam = two_spheres_scene(), _diffuse_cam()
    kw = dict(width=32, height=16, spp=2, max_bounces=3, seed=1)
    img, rays = render_scene_sharded(scene, cam, mesh=mesh, **kw)
    ref, ref_rays = mk.render_image_kernel(scene, cam, **kw)
    assert torch.equal(img, ref) and int(rays) == int(ref_rays)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (single_device_mesh, lambda: make_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(NotImplementedError, match="nee is for"):
        render_scene_sharded(object(), cam, 32, 16, mesh, nee=True)


@pytest.fixture(scope="module")
def jax_scene_refs():
    """JAX's render_image of each scene case, with the scene's hit function
    (and the mesh lamps for NEE). tests/test_parallel.py holds JAX's
    sharded renders to these."""
    from functools import partial

    from csgrenderer_tpu.camera import Camera as JCamera
    from csgrenderer_tpu.models import config3_csg_scene as j_config3
    from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
    from csgrenderer_tpu.models import two_spheres_scene as j_two
    from csgrenderer_tpu.render import concat_meshes as j_concat
    from csgrenderer_tpu.render import icosphere as j_ico
    from csgrenderer_tpu.render import integrator as j_integrator
    from csgrenderer_tpu.render import lights as jl
    from csgrenderer_tpu.render import quad as j_quad
    from csgrenderer_tpu.scene.graph import Material as JMat

    lib = dict(Material=JMat, two_spheres_scene=j_two, rtiow_final_scene=j_rtiow,
               config3_csg_scene=j_config3, icosphere=j_ico, concat_meshes=j_concat, quad=j_quad)
    refs = {}
    for name, (make, cam_spec, frame) in _scene_cases(lib).items():
        scene, cam = make(), _camera(cam_spec, JCamera)
        frame = dict(frame)
        nee = frame.pop("nee", False)
        hit_fn = partial(j_integrator.tape_hit_adapter, scene) if name == "tape" else scene.nearest_hit
        img, rays = j_integrator.render_image(
            hit_fn, cam, lights=jl.extract_mesh_lights(scene) if nee else None, **frame)
        refs[name] = (np.asarray(img), int(rays))
    return refs


@pytest.mark.parametrize("case", sorted(_scene_cases(PORT)))
def test_scene_sharded_branches(world, jax_scene_refs, case):
    """render_scene_sharded(device="cpu") at 2x1 and 2x2, one case per
    scene type (the branches __graft_entry__.dryrun_multichip covers for
    JAX): the port's unsharded kernel wrapper on the CPU bit for bit at
    2x1 and within atol 1e-5 at 2x2, rays equal; and JAX's render_image
    at the compare() bounds, and within the tolerance of
    tests/test_parallel.py (1e-5; 1e-4 for the tape) wherever the two
    packages' unsharded images agree."""
    make, cam_spec, frame = _scene_cases(PORT)[case]
    ref, ref_rays = _kernel_render(make(), _camera(cam_spec), **frame)
    (img21, rays21), (img22, rays22) = (world[0][("scene", case, k)] for k in ((2, 1), (2, 2)))
    assert torch.equal(img21, ref) and rays21 == int(ref_rays)
    np.testing.assert_allclose(img22.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert rays22 == int(ref_rays)
    assert float(ref.max()) > 0.05
    j_img, j_rays = jax_scene_refs[case]
    assert abs(rays22 - j_rays) <= max(j_rays * 2e-3, 8)
    bad = float((np.abs(img22.numpy() - j_img).max(axis=-1) > 0.05).mean())
    assert bad <= 0.01, f"{bad:.3%} divergent"
    atol = 1e-4 if case == "tape" else 1e-5
    agree = np.abs(ref.numpy() - j_img) <= atol
    np.testing.assert_allclose(img22.numpy()[agree], j_img[agree], atol=atol, rtol=0)


def test_canary_in_four_ranks(world):
    """Kernel row 9 in every rank of the 2x2 mesh. JAX's canary
    (tests/test_parallel.py::test_pallas_vma_checker_still_unsupported)
    expects its Pallas kernel inside shard_map(check_vma=True) to RAISE:
    jax's varying-axes checker cannot type it, hence render_scene_sharded's
    check_vma=False escape hatch there. torch.distributed has no such
    checker, so the expectation is inverted: each rank runs the kernel as
    a single-device caller would and gets 2x of its tile's input, equal to
    scale2_plain and torch.mul(x, 2.0) bit for bit; the port needs no
    escape hatch. (On the CPU the wrapper runs the plain version; the card
    test and chip_smoke.py launch the CUDA kernel.)"""
    for res in world[:4]:
        assert res["canary_equal"] == (True, True)
    want = torch.stack([torch.full(sc.SHAPE, 2.0 * (1 + i)) for i in range(2)])
    assert torch.equal(world[0]["canary"], want)
    assert all("canary_equal" not in res for res in world[4:])


def test_render_to_noise_sharded_matches_single_device(world):
    """render_to_noise_sharded at (4, 2) (tests/test_parallel.py's
    settings) against the port's PathTraceRenderer(device="cpu")
    .render_to_noise: spp used and rays equal, noise within rel 1e-5,
    images within atol 1e-5; every rank holds the same noise and stopped
    at the same count. Against JAX's jnp renderer, which
    tests/test_parallel.py holds JAX's render_to_noise_sharded to (rel
    1e-5): spp used equal, images within the compare() bounds, noise within
    rel 3e-3. At this frame 20 of the 2,048 pixels of the two packages'
    merged images differ (by at most 0.0105: XLA's fused arithmetic moves a
    few silhouette paths, as on config2's golden), and each moved sample
    shifts a 64x32 frame's noise by about 1e-3 of itself: measured 2.2e-3
    apart here (1.1e-3 at tests/test_torch_app.py's frame)."""
    from csgrenderer_tpu.app.renderers import PathTraceRenderer as JPathTraceRenderer
    from csgrenderer_tpu.camera import Camera as JCamera
    from csgrenderer_tpu.models import two_spheres_scene as j_two
    from csgrenderer_tpu.utils.config import RenderConfig as JRenderConfig

    assert len({res["noise"] for res in world}) == 1
    noise, used, rays, count = world[0]["noise"]
    frame = dict(width=64, height=32, spp=NOISE_KW["spp_chunk"],
                 max_bounces=NOISE_KW["max_bounces"], seed=NOISE_KW["seed"])
    single = PathTraceRenderer(two_spheres_scene(), _diffuse_cam(), RenderConfig(**frame),
                               device="cpu")
    acc_s, noise_s, used_s = single.render_to_noise(target=NOISE_KW["target"],
                                                    max_spp=NOISE_KW["max_spp"])
    assert used == used_s == count
    assert noise == pytest.approx(noise_s, rel=1e-5)
    assert rays == acc_s.rays_traced
    img = world[0]["noise_image"].numpy()
    np.testing.assert_allclose(img, acc_s.image().numpy(), atol=1e-5, rtol=0)
    j_acc, j_noise, j_used = JPathTraceRenderer(
        j_two(), _diffuse_cam(lib=JCamera), JRenderConfig(**frame), backend="jnp",
    ).render_to_noise(target=NOISE_KW["target"], max_spp=NOISE_KW["max_spp"])
    assert used == j_used
    assert float((np.abs(img - np.asarray(j_acc.image())).max(axis=-1) > 0.05).mean()) <= 0.01
    assert noise == pytest.approx(j_noise, rel=3e-3)
