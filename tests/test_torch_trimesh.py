"""The port's triangle meshes against the JAX package's, on the CPU: the
builders and OBJ input byte for byte, Möller-Trumbore on seeded rays, the
plain brute render against JAX ``render_image(mesh.nearest_hit)``, the
mesh kernel wrapper's modes and errors, and the CLI's meshnight.

The nearest-hit reference runs op by op (``jax.disable_jit()``): under
``jit`` XLA fuses the [rays, faces] plane and 30% of the nearest t's move
by an ulp; op by op they are bit-equal to the port's. The rendered frames
hold under ``jit`` too, at the bound of tests/test_tri_worklist.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.io import obj as j_obj
from csgrenderer_tpu.models import mesh_night_scene as j_mesh_night
from csgrenderer_tpu.render import integrator as j_integrator
from csgrenderer_tpu.render import trimesh as jt
from csgrenderer_tpu.scene import Material as JMat
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.convert import camera_from_numpy, mesh_from_numpy
from csgrenderer_tpu_torch.io import obj, read_png
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import mesh_demo_scene, mesh_night_scene
from csgrenderer_tpu_torch.render import render_image
from csgrenderer_tpu_torch.render import trimesh as pt
from csgrenderer_tpu_torch.scene import Material

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
MESH_FIELDS = ("v0", "e1", "e2", "mat_kind", "albedo", "mat_param")
CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius")
DEMO_EYE, DEMO_AT = (0.0, 1.6, 2.2), (0.0, 0.7, -2.6)  # tools/bench_mesh.py's camera


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_mesh(port, jax_mesh):
    for f in MESH_FIELDS:
        assert getattr(port, f).numpy().tobytes() == np.asarray(getattr(jax_mesh, f)).tobytes(), f


def j_demo_mesh(sub):
    """tests/test_tri_worklist.py's demo_mesh (demo 7's scene)."""
    return jt.concat_meshes(
        jt.icosphere((-1.1, 0.8, -3.2), 0.8, JMat.metal((0.9, 0.8, 0.6), 0.05), sub),
        jt.icosphere((1.1, 0.8, -3.0), 0.8, JMat.dielectric(1.5), sub),
        jt.icosphere((0.0, 0.45, -1.9), 0.45, JMat.lambertian((0.2, 0.35, 0.7)), sub),
        jt.quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), JMat.lambertian((0.55, 0.55, 0.5))),
    )


def port_mesh(jmesh):
    return mesh_from_numpy(*(np.asarray(getattr(jmesh, f)) for f in MESH_FIELDS))


def port_camera(jcam):
    return camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS))


def seeded_rays(n, seed=0):
    """tests/test_tri_worklist.py's fuzz rays: origins around the demo
    scene aimed at points inside it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3, 0.1, -5], [3, 2.5, 1], (n, 3)).astype(np.float32)
    tgt = rng.uniform([-2, 0, -4], [2, 1.6, -1], (n, 3)).astype(np.float32)
    return o, (tgt - o).astype(np.float32)


@pytest.mark.parametrize("sub", [0, 1, 2, 3])
def test_icosphere_byte_identical(sub):
    args = ((0.3, -0.2, -4.0), 1.7)
    icos = pt.icosphere(*args, Material.metal((0.9, 0.8, 0.6), 0.3), sub)
    assert_same_mesh(icos, jt.icosphere(*args, JMat.metal((0.9, 0.8, 0.6), 0.3), sub))
    assert icos.num_faces == 20 * 4 ** sub


def test_builders_and_scenes_byte_identical():
    corners = ((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2))
    assert_same_mesh(pt.quad(*corners, Material.emissive((4.0, 7.0, 12.0))),
                     jt.quad(*corners, JMat.emissive((4.0, 7.0, 12.0))))
    verts, faces = [[-1, -1, -3], [1, -1, -3], [0, 1, -3], [0, 0, -2]], [[0, 1, 2], [0, 3, 1]]
    assert_same_mesh(pt.make_mesh(verts, faces, Material.dielectric(1.5)),
                     jt.make_mesh(verts, faces, JMat.dielectric(1.5)))
    assert_same_mesh(mesh_night_scene(), j_mesh_night())
    assert mesh_night_scene().num_faces == 966
    assert_same_mesh(mesh_demo_scene(2), j_demo_mesh(2))
    assert mesh_demo_scene(4).num_faces == 15362 and mesh_demo_scene(5, 5).num_faces == 102402


def test_obj_read_write_match_jax(tmp_path):
    """tests/test_trimesh.py's fan and negative-index file, and the writer's
    text, as the JAX io.obj reads and writes them."""
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f 1/1/1 2/2/2 3/3/3 4/4/4\n"  # quad with v/vt/vn tokens
        "f -4 -3 -2\n"  # negative indices
    )
    verts, faces = obj.read_obj(p)
    jv, jf = j_obj.read_obj(p)
    assert len(verts) == 4 and len(faces) == 3  # 2 from the fan + 1
    assert verts.tobytes() == jv.tobytes() and faces.tobytes() == jf.tobytes()
    assert faces.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 2]]

    mesh = pt.icosphere((0, 0, 0), 1.0, Material.normal_map(), 1)
    v0 = mesh.v0.numpy()
    verts = np.concatenate([v0, v0 + mesh.e1.numpy(), v0 + mesh.e2.numpy()])
    f = len(v0)
    faces = np.stack([np.arange(f), np.arange(f) + f, np.arange(f) + 2 * f], axis=1)
    obj.write_obj(tmp_path / "a.obj", verts, faces)
    j_obj.write_obj(tmp_path / "b.obj", verts, faces)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()
    assert_same_mesh(obj.load_mesh(tmp_path / "a.obj", Material.normal_map()),
                     j_obj.load_mesh(tmp_path / "b.obj", JMat.normal_map()))
    with pytest.raises(ValueError, match="no triangles"):
        (tmp_path / "empty.obj").write_text("# nothing\n")
        obj.read_obj(tmp_path / "empty.obj")


def test_nearest_hit_matches_jax():
    """Seeded rays against the demo mesh: t, face, normal and front face
    equal to the JAX nearest hit run op by op, with and without face
    chunks."""
    o, d = seeded_rays(1024)
    jmesh = j_demo_mesh(2)
    with jax.disable_jit():
        h = jmesh.nearest_hit(jnp.asarray(o), jnp.asarray(d))
    mesh = port_mesh(jmesh)
    for chunk in (None, 100):
        p = mesh.nearest_hit(torch.from_numpy(o), torch.from_numpy(d), face_chunk=chunk)
        assert p.t.numpy().tobytes() == np.asarray(h.t).tobytes()
        assert np.array_equal(p.hit.numpy(), np.asarray(h.hit))
        assert np.array_equal(p.front_face.numpy(), np.asarray(h.front_face))
        assert np.array_equal(p.mat_kind.numpy(), np.asarray(h.mat_kind))
        # rsqrt differs by an ulp between torch's CPU kernel and XLA's
        np.testing.assert_allclose(p.normal.numpy(), np.asarray(h.normal), rtol=0, atol=3e-7)
    assert 0.2 < float(p.hit.float().mean()) < 1.0


def test_single_triangle_hit_miss_and_degenerate():
    mesh = pt.make_mesh([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [[0, 1, 2]],
                        Material.lambertian((0.5, 0.5, 0.5)))
    o = torch.tensor([[0.0, 0, 0], [0, 0, 0]])
    d = torch.tensor([[0.0, 0, -1], [0, 0, 1]])
    h = mesh.nearest_hit(o, d)
    assert bool(h.hit[0]) and not bool(h.hit[1])
    assert abs(float(h.t[0]) - 3.0) < 1e-5 and bool(h.front_face[0])
    np.testing.assert_allclose(h.normal[0].numpy(), [0, 0, 1], atol=1e-6)
    # zero-area faces (a point, a segment, all zero) are never hit: det = 0
    v0 = np.array([[0.0, 0.0, -2.0], [-0.5, 0.0, -2.0], [0, 0, 0]], np.float32)
    e1 = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0, 0, 0]], np.float32)
    flat = mesh_from_numpy(v0, e1, 2 * e1, np.ones(3), np.full((3, 3), 0.5), np.zeros(3))
    dd = torch.tensor([[0.0, 0.0, -1.0], [0.01, 0.0, -1.0], [0.0, 0.0, 1.0]])
    assert not bool(flat.nearest_hit(torch.zeros(3, 3), dd).hit.any())


def test_watertight_icosphere():
    """Rays from the centre of an icosphere all hit it (no edge leaks)."""
    mesh = pt.icosphere((0, 0, 0), 1.0, Material.lambertian((0.5, 0.5, 0.5)), 2)
    d = torch.from_numpy(np.random.default_rng(3).normal(size=(512, 3)).astype(np.float32))
    assert bool(mesh.nearest_hit(torch.zeros(512, 3), d).hit.all())


def test_plain_brute_render_matches_jax():
    """The brute plain version against JAX render_image(mesh.nearest_hit)
    at tests/test_tri_worklist.py's frame (64x36, 4 spp, 4 bounces, seed
    7) on the demo mesh forced brute; the bound there is RMSE < 1.5e-3,
    and rays are exact."""
    kw = dict(width=64, height=36, spp=4, max_bounces=4, seed=7)
    jmesh = j_demo_mesh(1)
    jcam = JCamera.look_at(DEMO_EYE, DEMO_AT, vfov_degrees=45.0, aspect_ratio=64 / 36)
    ref, ref_rays = j_integrator.render_image(jmesh.nearest_hit, jcam, **kw)
    packed = tm.pack_mesh(port_mesh(jmesh), False)
    assert packed.mode == "brute"
    img, rays = tm.render_image_mesh_kernel(packed, port_camera(jcam), **kw)
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - img.numpy()) ** 2)))
    assert rmse < 1.5e-3, rmse
    assert int(rays) == int(ref_rays)
    direct, d_rays = render_image(packed.mesh.nearest_hit, port_camera(jcam), **kw)
    assert torch.equal(direct, img) and int(d_rays) == int(rays)


def test_kernel_wrapper_modes_and_errors():
    small = pt.concat_meshes(
        pt.icosphere((0.0, 0.45, -1.9), 0.45, Material.lambertian((0.2, 0.35, 0.7)), 1),
        pt.quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), Material.lambertian((0.5,) * 3)))
    assert small.num_faces == 82
    assert tm.pack_mesh(small).mode == "brute"  # under the 192-face grid threshold
    with pytest.raises(ValueError, match="not griddable"):
        tm.pack_mesh(small, True)
    for mode in ("stream", "tiered"):
        with pytest.raises(ValueError, match="TPU gather mode"):
            tm.pack_mesh(small, mode)
    packed = tm.pack_mesh(small)
    assert packed.lamps is None and packed.lights is None
    assert packed.faces.shape == (82, tm.FACE_WORDS)
    np.testing.assert_array_equal(packed.normals.numpy(), small.face_normals.numpy())
    cam = Camera.look_at(DEMO_EYE, DEMO_AT, vfov_degrees=45.0, aspect_ratio=2.0)
    with pytest.raises(ValueError, match="emissive"):
        tm.render_image_mesh_kernel(packed, cam, 8, 4, nee=True)
    with pytest.raises(ValueError, match="emissive"):
        tm.render_image_mesh_plain(packed, cam, 8, 4, nee=True)
    with pytest.raises(ValueError, match="fixed"):
        tm.render_image_mesh_kernel(packed, cam, 8, 4, worklist=False)
    with pytest.raises(ValueError, match="needs CUDA"):
        tm._launch(packed, cam.origin, 8, 4, 1, 1, 0, 0, False, "rtiow", False)
    before = (tm.LAUNCHES, dict(tm.LAUNCHES_BY_MODE))
    img, rays = tm.render_image_mesh_kernel(small, cam, 16, 8, spp=1, max_bounces=3)
    assert (tm.LAUNCHES, dict(tm.LAUNCHES_BY_MODE)) == before  # CPU tensors never launch
    assert img.shape == (8, 16, 3) and int(rays) >= 16 * 8


def test_cli_renders_meshnight(tmp_path):
    out = tmp_path / "meshnight.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs in several workers at once
    proc = subprocess.run(
        [sys.executable, "-m", "csgrenderer_tpu_torch", "render", "--scene", "meshnight",
         "--width", "24", "--height", "16", "--spp", "1", "--bounces", "3", "--device", "cpu",
         "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = read_png(out)
    assert img.shape == (16, 24, 3) and img.max() > 0
