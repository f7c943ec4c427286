"""Next-event estimation toward emissive mesh faces in the port, on the
CPU: the lamp table against the JAX packer's layout, the plain brute and
grid versions with triangle lamps against JAX ``render_image(...,
lights=extract_mesh_lights(mesh))`` on the scenes of tests/test_nee.py
(the small mesh night, the brute-path lamp scene, the 80-lamp scene) at
their bounds with rays exact, and the config7 meshnight golden.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.render import integrator as j_integrator
from csgrenderer_tpu.render import lights as jl
from csgrenderer_tpu.render import trimesh as jt
from csgrenderer_tpu.scene import Material as JMat
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.io import read_png, rmse
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import mesh_night_scene
from csgrenderer_tpu_torch.render import lights as tl
from csgrenderer_tpu_torch.render import render_image
from csgrenderer_tpu_torch.render.tonemap import to_uint8, tonemap
from test_torch_trimesh import GOLDENS, port_camera, port_mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def j_small_mesh_night():
    """tests/test_nee.py's small_mesh_night: a lamp quad over a Lambertian
    and a glossy-metal icosphere, 644 faces."""
    return jt.concat_meshes(
        jt.icosphere((-0.9, 0.7, -3.0), 0.7, JMat.lambertian((0.6, 0.3, 0.3)), 2),
        jt.icosphere((1.0, 0.6, -2.7), 0.6, JMat.metal((0.8, 0.7, 0.5), 0.2), 2),
        jt.quad((-0.6, 2.4, -3.2), (0.6, 2.4, -3.2), (0.6, 2.4, -2.0), (-0.6, 2.4, -2.0),
                JMat.emissive((14.0, 12.0, 9.0))),
        jt.quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), JMat.lambertian((0.5, 0.5, 0.5))),
    )


def j_lamp_scene():
    """tests/test_nee.py's brute-path mesh NEE scene (82 faces, 2 lamps)."""
    return jt.concat_meshes(
        jt.icosphere((0, 0.7, -3), 0.7, JMat.lambertian((0.6, 0.3, 0.3)), 1),
        jt.quad((-0.6, 2.2, -3.4), (0.6, 2.2, -3.4), (0.6, 2.2, -2.4), (-0.6, 2.2, -2.4),
                JMat.emissive((12.0, 10.0, 8.0))),
    )


def j_lamps80_scene():
    """tests/test_nee.py's many-lamp scene: an emissive icosphere, 80 lamps."""
    return jt.concat_meshes(
        jt.icosphere((-0.9, 0.7, -3.0), 0.7, JMat.lambertian((0.6, 0.3, 0.3)), 2),
        jt.icosphere((0.2, 2.2, -2.6), 0.35, JMat.emissive((14.0, 12.0, 9.0)), 1),
        jt.quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), JMat.lambertian((0.5, 0.5, 0.5))),
    )


MESH_CAM = ((0, 1.6, 2.2), (0, 0.7, -2.6), 45.0)  # tests/test_nee.py's MESH_CAM
LAMP_CAM = ((0, 1.4, 1.6), (0, 0.6, -3), 50.0)
# scene, camera, frame, mode, bound: "rmse" (RMSE < 1e-5) or "bad" (at most
# 1% of pixels off by more than 0.05), as tests/test_nee.py holds the JAX
# brute and grid kernels
CASES = {
    "small-night-grid": (j_small_mesh_night, MESH_CAM, dict(spp=3, max_bounces=4), True, "bad"),
    "small-night-brute": (j_small_mesh_night, MESH_CAM, dict(spp=3, max_bounces=4), False, "bad"),
    "lamp-scene-brute": (j_lamp_scene, LAMP_CAM, dict(spp=3, max_bounces=4), "auto", "rmse"),
    "lamps80-grid": (j_lamps80_scene, MESH_CAM, dict(spp=2, max_bounces=3), True, "bad"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_nee_matches_jax(case):
    make, (eye, at, vfov), frame, worklist, bound = CASES[case]
    kw = dict(width=48, height=24, seed=7, sky="black", **frame)
    jmesh = make()
    jcam = JCamera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=2.0)
    ref, ref_rays = j_integrator.render_image(jmesh.nearest_hit, jcam,
                                              lights=jl.extract_mesh_lights(jmesh), **kw)
    ref = np.asarray(ref)
    packed = tm.pack_mesh(port_mesh(jmesh), worklist)
    assert packed.mode == case.rsplit("-", 1)[1]
    img, rays = tm.render_image_mesh_kernel(packed, port_camera(jcam), nee=True, **kw)
    img = img.numpy()
    assert int(rays) == int(ref_rays)
    if bound == "rmse":
        assert float(np.sqrt(np.mean((img - ref) ** 2))) < 1e-5
    else:
        bad = float((np.abs(img - ref).max(axis=-1) > 0.05).mean())
        assert bad <= 0.01, f"{bad:.3%} divergent"
    assert img.max() > 0.05  # lit by the lamps alone (black sky)


def test_lamp_table_matches_jax_layout():
    """The [n_lights, 16] rows of the JAX mesh packer
    (trimesh_kernel.py:771-777): v0, e1, e2, emitted rgb, unit normal,
    area, from extract_mesh_lights, in face order."""
    jmesh = j_lamps80_scene()
    lights = jl.extract_mesh_lights(jmesh)
    want = np.zeros((lights.num_lights, 16), np.float32)
    want[:, 0:3], want[:, 3:6], want[:, 6:9] = lights.v0, lights.e1, lights.e2
    want[:, 9:12], want[:, 12:15], want[:, 15] = lights.emit, lights.normal, lights.area
    packed = tm.pack_mesh(port_mesh(jmesh))
    assert packed.lamps.shape == (80, tm.LAMP_WORDS)
    np.testing.assert_array_equal(packed.lamps.numpy(), want)
    for a, b in zip(packed.lights, tl.extract_mesh_lights(packed.mesh)):
        assert torch.equal(a, b)


def test_nee_kernel_on_cpu_equals_plain_and_modes_agree():
    """render_image_mesh_kernel(nee=True) on CPU tensors is its plain
    version in both modes; grid and brute render the same image; NEE
    changes it; the counts of the NEE work and of the walk add up."""
    mesh = mesh_night_scene()
    cam = Camera.look_at((0, 1.8, 2.4), (0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=2.0)
    kw = dict(width=32, height=16, spp=2, max_bounces=4, seed=3, sky="black")
    images = {}
    for worklist in (True, False):
        packed = tm.pack_mesh(mesh, worklist)
        assert packed.lamps.shape == (4, tm.LAMP_WORDS)
        before = (tm.LAUNCHES, dict(tm.LAUNCHES_BY_MODE))
        img, rays = tm.render_image_mesh_kernel(packed, cam, nee=True, **kw)
        assert (tm.LAUNCHES, dict(tm.LAUNCHES_BY_MODE)) == before  # CPU tensors never launch
        counts = {}
        ref, ref_rays = tm.render_image_mesh_plain(packed, cam, nee=True, counts=counts, **kw)
        assert torch.equal(img, ref) and int(rays) == int(ref_rays)
        c = {k: int(v) for k, v in counts.items()}
        assert 0 < c["shadow_clear"] <= c["shadow_rays"] <= c["nee_vertices"] < int(rays)
        if worklist:
            assert c["walks"] > 0 and c["face_tests"] > 0 and c["voxel_visits"] >= c["walks"]
        images[packed.mode] = (img, rays)
    assert torch.equal(*(x[0] for x in images.values()))
    plain, _ = tm.render_image_mesh_kernel(mesh, cam, **kw)
    assert not torch.equal(plain, images["grid"][0])


def test_golden_config7_meshnight():
    """tools/make_goldens.py config7 (mesh_night_scene through the CLI's
    meshnight camera, 160x90, 8 spp, 5 bounces, seed 7, black sky, NEE)
    from the port's plain grid path: RMSE <= 1e-3 (the BASELINE criterion
    of tests/test_golden.py)."""
    cam = Camera.look_at((0, 1.8, 2.4), (0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=160 / 90)
    img, _ = tm.render_image_mesh_kernel(mesh_night_scene(), cam, 160, 90, spp=8, max_bounces=5,
                                         seed=7, sky="black", nee=True)
    err = rmse(to_uint8(tonemap(img, gamma=2.0)).numpy(),
               read_png(GOLDENS / "config7_meshnight.png"))
    assert err <= 1e-3, f"RMSE {err}"


def test_integrator_with_tri_lights_matches_kernel_plain():
    """The integrator's lights= with extract_mesh_lights and the mesh's
    own nearest hit is the brute plain version."""
    mesh = port_mesh(j_lamp_scene())
    cam = Camera.look_at(*LAMP_CAM[:2], vfov_degrees=LAMP_CAM[2], aspect_ratio=2.0)
    kw = dict(width=24, height=12, spp=2, max_bounces=3, seed=1, sky="black")
    direct, d_rays = render_image(mesh.nearest_hit, cam, lights=tl.extract_mesh_lights(mesh), **kw)
    img, rays = tm.render_image_mesh_kernel(mesh, cam, nee=True, **kw)
    assert torch.equal(direct, img) and int(d_rays) == int(rays)
