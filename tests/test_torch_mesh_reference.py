"""The benchmark's plain mesh reference (``benchmark/reference/mesh.py``,
which imports nothing of the port) against the port's plain mesh path, on
the CPU, and the port's triangle-test count.

On CPU tensors the port's mesh path is the kernel's plain version
(``render/trimesh.py``, ``kernels/tri_worklist.py``), which the kernel
repeats operation for operation; the reference builds its own triangles
from the configuration file and tests them by the same Möller-Trumbore
operations, so on the CPU the two agree exactly:

- the reference's faces, materials and normals are the bytes of
  ``models.mesh_demo_scene`` at subdivision 1 and 2;
- on seeded random rays, its nearest hits (t, hit, face normal, material)
  are the port's brute force and grid walk's, bit for bit, and on seeded
  random triangles the brute force's; its culling by boxes never changes a
  hit (culled and uncut keys equal);
- a frame's radiance through the reference's bounce loop
  (``benchmark/reference/core.py``) is the port's progressive frame's
  within 1e-6 in every channel, and its segments are equal;
- the port's triangle tests of a frame are its walk's ``global_tests +
  face_tests`` of the path segments (faces x segments in brute mode), and
  ``PathTraceRenderer`` reads them at its fence.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import camera  # noqa: E402
from benchmark.reference import core  # noqa: E402
from benchmark.reference import mesh as ref  # noqa: E402
from csgrenderer_tpu_torch.app import PathTraceRenderer  # noqa: E402
from csgrenderer_tpu_torch.camera import Camera  # noqa: E402
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm  # noqa: E402
from csgrenderer_tpu_torch.kernels.tri_worklist import tri_grid_nearest_hit  # noqa: E402
from csgrenderer_tpu_torch.models import mesh_demo_scene  # noqa: E402
from csgrenderer_tpu_torch.render.trimesh import (  # noqa: E402
    brute_nearest,
    concat_meshes,
    icosphere,
    quad,
)
from csgrenderer_tpu_torch.scene import Material  # noqa: E402
from csgrenderer_tpu_torch.utils.config import RenderConfig  # noqa: E402

CONFIG = json.loads((REPO / "benchmark" / "configs" / "mesh102k_demo7.json").read_text())
WIDTH, HEIGHT, SPP = 48, 27, 2
RADIANCE_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene_at(subdiv: int) -> dict:
    return {**CONFIG["scene"], "subdiv": subdiv}


def random_rays(n: int, seed: int):
    """Rays from around the camera into the scene, and some from inside it."""
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * torch.tensor([8.0, 2.5, 6.0]) - torch.tensor(
        [4.0, -0.2, 5.5])
    target = torch.rand((n, 3), generator=g) * torch.tensor([6.0, 1.8, 5.0]) - torch.tensor(
        [3.0, 0.0, 6.5])
    return o, target - o


@pytest.mark.parametrize("subdiv", [1, 2])
def test_the_reference_builds_the_programs_faces(subdiv):
    soup = ref.MeshSoup.build(ref.parts_of(scene_at(subdiv)), torch.float32, "cpu")
    mesh = mesh_demo_scene(subdiv, spheres=len(CONFIG["scene"]["spheres"]))
    assert soup.num_faces == mesh.num_faces == 5 * 20 * 4 ** subdiv + 2
    for mine, theirs in ((soup.v0, mesh.v0), (soup.e1, mesh.e1), (soup.e2, mesh.e2),
                         (soup.albedo, mesh.albedo), (soup.mat_param, mesh.mat_param),
                         (soup.normal, mesh.face_normals), (soup.mat_kind, mesh.mat_kind)):
        assert torch.equal(mine, theirs)
    assert soup.always.tolist() == [mesh.num_faces - 2, mesh.num_faces - 1]


@pytest.mark.parametrize("subdiv", [1, 2])
def test_the_reference_hits_what_the_programs_brute_force_and_walk_hit(subdiv):
    soup = ref.MeshSoup.build(ref.parts_of(scene_at(subdiv)), torch.float32, "cpu")
    packed = tm.pack_mesh(mesh_demo_scene(subdiv, spheres=5))
    assert packed.mode == "grid"
    o, d = random_rays(20000, 11 + subdiv)
    h = soup.nearest_hit(o, d)
    t_brute, id_brute = brute_nearest(o, d, packed.mesh.v0, packed.mesh.e1, packed.mesh.e2)
    t_grid, id_grid, _ = tri_grid_nearest_hit(packed.grid, packed.mesh, o, d)
    hit = t_brute < 5e29
    assert 0.3 < float(hit.float().mean()) < 0.95
    assert torch.equal(h.hit, hit) and torch.equal(h.t[hit], t_brute[hit])
    assert torch.equal(t_grid, t_brute) and torch.equal(id_grid[hit], id_brute[hit])
    shading = packed.mesh.surface_hit(d, t_brute, id_brute, packed.normals)
    for mine, theirs in ((h.normal, shading.normal), (h.front_face, shading.front_face),
                         (h.mat_kind, shading.mat_kind), (h.albedo, shading.albedo),
                         (h.mat_param, shading.mat_param)):
        assert torch.equal(mine[hit], theirs[hit])
    uncut = ref.MeshSoup(**{**soup.__dict__, "cull": False})
    assert torch.equal(soup._nearest(o, d), uncut._nearest(o, d))


@pytest.mark.parametrize("seed", [3, 2**31 + 977])
def test_seeded_random_triangles_hit_alike_culled_or_not(seed):
    rng = np.random.default_rng(seed)
    n = 400
    v0 = rng.uniform(-2.0, 2.0, (n, 3))
    verts = np.concatenate([v0, v0 + rng.normal(0, 0.3, (n, 3)),
                            v0 + rng.normal(0, 0.3, (n, 3))]).astype(np.float32)
    faces = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1)
    floor = ref.quad([[-5.0, -2.5, -5.0], [5.0, -2.5, -5.0], [5.0, -2.5, 5.0], [-5.0, -2.5, 5.0]])
    parts = [ref.Part(verts, faces, 1, (0.5, 0.5, 0.5), 0.0, True),
             ref.Part(*floor, 2, (0.8, 0.8, 0.8), 0.1, False)]
    soup = ref.MeshSoup.build(parts, torch.float32, "cpu")
    g = torch.Generator().manual_seed(seed % 2**31)
    o = torch.randn((30000, 3), generator=g) * 3.0
    d = torch.randn((30000, 3), generator=g)
    culled = soup._nearest(o, d)
    assert torch.equal(culled, ref.MeshSoup(**{**soup.__dict__, "cull": False})._nearest(o, d))
    t_brute, id_brute = brute_nearest(o, d, soup.v0, soup.e1, soup.e2)
    h = soup.nearest_hit(o, d)
    hit = t_brute < 5e29
    assert int(hit.sum()) > 3000
    assert torch.equal(h.hit, hit) and torch.equal(h.t[hit], t_brute[hit])
    assert torch.equal(culled[hit] & 0xFFFFFFFF, id_brute[hit])


def program_frame(subdiv: int, seed: int):
    """(radiance, segments, triangle tests, walk's path counts) of the
    port's first progressive frame of the cell's scene at ``subdiv``."""
    scene = mesh_demo_scene(subdiv, spheres=5)
    cam = Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(CONFIG, {}))
    rc = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_bounces=CONFIG["bounces"],
                      seed=seed, sky=CONFIG["sky"], gamma=CONFIG["gamma"])
    r = PathTraceRenderer(scene, cam, rc, progressive=True, device="cpu")
    r.draw_frame(0.0)
    radiance = r.accumulator.radiance_sum / SPP
    counts = {}
    tm.render_image_mesh_plain(r._packed, cam, WIDTH, HEIGHT, spp=SPP,
                               max_bounces=CONFIG["bounces"], seed=seed, sky=CONFIG["sky"],
                               counts=counts)
    return radiance, r.last_frame_rays, r.last_frame_tri_tests, counts


@pytest.mark.parametrize("subdiv,seed", [(1, 5), (2, 2**31 + 977)])
def test_a_frame_through_the_reference_is_the_programs(subdiv, seed):
    radiance, rays, tests, _ = program_frame(subdiv, seed)
    soup = ref.MeshSoup.build(ref.parts_of(scene_at(subdiv)), torch.float32, "cpu")
    cam = core.Camera.look_at(aspect_ratio=WIDTH / HEIGHT, **camera(CONFIG, {}))
    img, ref_rays = core.render_rows(soup.nearest_hit, cam, WIDTH, HEIGHT, list(range(HEIGHT)),
                                     SPP, CONFIG["bounces"], seed, CONFIG["sky"], False,
                                     sample_offset=0)
    assert int(ref_rays) == rays
    assert float((img.double() - radiance.double()).abs().max()) <= RADIANCE_TOL
    assert tests > 2 * rays


@pytest.mark.parametrize("subdiv", [1, 2])
def test_the_triangle_tests_are_the_walks_path_tests(subdiv):
    _, rays, tests, counts = program_frame(subdiv, 9)
    assert tests == int(counts["tri_tests"])
    assert tests == int(counts["global_tests"]) + int(counts["face_tests"])
    assert int(counts["global_tests"]) == 2 * rays  # the floor's two faces, every segment


def test_brute_mode_counts_every_face_a_segment_and_nee_leaves_shadow_rays_out():
    lamp = concat_meshes(
        icosphere((0, 0.7, -3), 0.7, Material.lambertian((0.6, 0.3, 0.3)), 1),
        quad((-0.6, 2.2, -3.4), (0.6, 2.2, -3.4), (0.6, 2.2, -2.4), (-0.6, 2.2, -2.4),
             Material.emissive((12.0, 10.0, 8.0))))
    cam = Camera.look_at((0, 1.4, 1.6), (0, 0.6, -3), vfov_degrees=50.0, aspect_ratio=2.0)
    frame = dict(width=32, height=16, spp=2, max_bounces=4, seed=4, sky="black")
    brute = tm.pack_mesh(lamp)
    assert brute.mode == "brute"
    for nee in (False, True):
        counts = {}
        _, rays = tm.render_image_mesh_kernel(brute, cam, nee=nee, counts=counts, **frame)
        assert int(counts["tri_tests"]) == int(rays) * lamp.num_faces
        assert ("shadow_rays" in counts) == nee
    night = mesh_demo_scene(1, spheres=5)
    grid = tm.pack_mesh(concat_meshes(night, quad(
        (-0.6, 2.4, -3.4), (0.6, 2.4, -3.4), (0.6, 2.4, -2.4), (-0.6, 2.4, -2.4),
        Material.emissive((12.0, 10.0, 8.0)))))
    assert grid.mode == "grid"
    with_nee, without = {}, {}
    tm.render_image_mesh_kernel(grid, cam, nee=True, counts=with_nee, **frame)
    assert int(with_nee["shadow_rays"]) > 0
    # the shadow rays' walks are in the walk's counts, and out of the triangle tests
    path = with_nee["tri_tests"]
    assert int(path) < int(with_nee["global_tests"]) + int(with_nee["face_tests"])
    tm.render_image_mesh_kernel(grid, cam, nee=False, counts=without, **frame)
    assert int(without["tri_tests"]) == int(without["global_tests"]) + int(
        without["face_tests"])


def test_sphere_and_tape_frames_read_no_triangle_tests():
    from csgrenderer_tpu_torch.models import two_spheres_scene

    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90.0, aspect_ratio=2.0)
    r = PathTraceRenderer(two_spheres_scene(), cam, RenderConfig(width=16, height=8, spp=1),
                          progressive=True, device="cpu")
    r.draw_frame(0.0)
    assert r.last_frame_tri_tests is None and r.last_frame_shadow_rays == 0


def test_a_mesh_nee_frame_reads_its_triangle_tests_and_no_shadow_rays():
    """As on the card, where the mesh kernel counts no shadow rays: the
    renderer reads the frame's triangle tests, and None for shadow rays."""
    from csgrenderer_tpu_torch.models import mesh_night_scene

    cam = Camera.look_at((0, 1.8, 2.4), (0.0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=2.0)
    rc = RenderConfig(width=16, height=8, spp=1, max_bounces=3, sky="black", nee=True)
    r = PathTraceRenderer(mesh_night_scene(1), cam, rc, progressive=True, device="cpu")
    r.draw_frame(0.0)
    assert r.last_frame_shadow_rays is None
    assert r.last_frame_tri_tests > 0 and r.last_frame_rays > 0
