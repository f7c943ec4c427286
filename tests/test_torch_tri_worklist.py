"""The port's voxel-grid packer and plain walk (kernels/tri_worklist.py),
on the CPU: the SAT test against the JAX package's, the packer's
invariants, the walk against brute Möller-Trumbore on seeded and awkward
rays, and the plain grid render against JAX
``render_image(mesh.nearest_hit)`` at the bound of
tests/test_tri_worklist.py (RMSE < 1.5e-3, rays exact).
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels.tri_worklist import _tri_box_overlap
from csgrenderer_tpu.render import integrator as j_integrator
from csgrenderer_tpu_torch.kernels import tri_worklist as tw
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import mesh_demo_scene
from csgrenderer_tpu_torch.render import trimesh as pt
from csgrenderer_tpu_torch.scene import Material
from test_torch_trimesh import DEMO_AT, DEMO_EYE, j_demo_mesh, port_camera, port_mesh, seeded_rays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def test_sat_overlap_basics():
    """tests/test_tri_worklist.py's unit triangle and four boxes."""
    v = [np.array(p, np.float64) for p in ([0, 0, 0], [1, 0, 0], [0, 1, 0])]
    centers = np.array([
        [0.25, 0.25, 0.0],  # on the triangle
        [5.0, 5.0, 0.0],  # far away in-plane
        [0.25, 0.25, 2.0],  # above the plane
        [0.9, 0.9, 0.0],  # near the hypotenuse, just outside
    ])
    got = tw.tri_box_overlap_pairs(*(_f64(np.tile(p, (4, 1))) for p in v), _f64(centers), 0.2)
    assert got.tolist() == [True, False, False, False]


def test_sat_decisions_match_jax():
    """Faces of the demo mesh against boxes around them, many grazing: the
    same keep decision as the JAX numpy SAT for every pair."""
    mesh = mesh_demo_scene(2)
    rng = np.random.default_rng(5)
    ids = rng.choice(mesh.num_faces - 2, 40, replace=False)
    v0 = mesh.v0.numpy().astype(np.float64)[ids]
    v1 = v0 + mesh.e1.numpy().astype(np.float64)[ids]
    v2 = v0 + mesh.e2.numpy().astype(np.float64)[ids]
    half = 0.05
    kept = 0
    for k in range(len(ids)):
        centers = v0[k] + rng.uniform(-0.2, 0.2, (64, 3))
        want = _tri_box_overlap(v0[k], v1[k], v2[k], centers, half)
        got = tw.tri_box_overlap_pairs(*(_f64(np.tile(p[k], (64, 1))) for p in (v0, v1, v2)),
                                       _f64(centers), half)
        assert got.tolist() == want.tolist()
        kept += int(want.sum())
    assert 0 < kept < 40 * 64


def test_packer_invariants():
    mesh = mesh_demo_scene(3)
    pack = tw.pack_tri_grid(mesh)
    gs = pack.static
    # the floor quad's two big faces are the globals; every other face is gridded
    assert pack.globals_idx.tolist() == [mesh.num_faces - 2, mesh.num_faces - 1]
    offsets, ids = pack.offsets.long(), pack.face_ids.long()
    assert offsets.shape == (gs.n_voxels + 1,) and int(offsets[0]) == 0
    assert int(offsets[-1]) == ids.numel() and bool((offsets[1:] >= offsets[:-1]).all())
    assert set(ids.unique().tolist()) == set(range(mesh.num_faces - 2))
    lens = offsets[1:] - offsets[:-1]
    for v in torch.nonzero(lens)[:, 0].tolist():  # ascending, no repeats, within a voxel
        lst = ids[offsets[v]:offsets[v + 1]]
        assert bool((lst[1:] > lst[:-1]).all())
    # every listed (face, voxel) pair overlaps by the SAT test, and the
    # voxel lies in the face's bounding box of voxels
    vox = torch.repeat_interleave(torch.arange(gs.n_voxels), lens)
    iz, iy, ix = vox % gs.nz, (vox // gs.nz) % gs.ny, vox // (gs.nz * gs.ny)
    centers = _f64([gs.x0, gs.y0, gs.z0]) + (torch.stack([ix, iy, iz], 1).double() + 0.5) * gs.cell
    v0 = mesh.v0.double()[ids]
    v1, v2 = v0 + mesh.e1.double()[ids], v0 + mesh.e2.double()[ids]
    assert bool(tw.tri_box_overlap_pairs(v0, v1, v2, centers, gs.cell / 2).all())
    # the occupancy rule: the first rung at most TARGET_OCCUPANCY, the
    # coarser ones above it
    mean_occ, max_occ, nonempty = pack.occupancy()
    assert [r[0] for r in pack.rungs] == list(tw.N_SIDES[:len(pack.rungs)])
    assert all(r[2] > tw.TARGET_OCCUPANCY for r in pack.rungs[:-1])
    assert mean_occ <= tw.TARGET_OCCUPANCY and pack.rungs[-1][1] == gs.dims
    assert nonempty == int((lens > 0).sum()) and max_occ == int(lens.max())


def test_under_192_faces_takes_no_grid():
    small = pt.concat_meshes(
        pt.icosphere((0.0, 0.45, -1.9), 0.45, Material.lambertian((0.2, 0.35, 0.7)), 1),
        pt.quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), Material.lambertian((0.5,) * 3)))
    assert tw.pack_tri_grid(small) is None
    assert tm.pack_mesh(small).mode == "brute"
    with pytest.raises(ValueError, match="not griddable"):
        tm.pack_mesh(small, True)
    # 200 faces, of which 40 are big (globals): 160 left to grid, no grid either
    mat = Material.lambertian((0.5,) * 3)
    parts = [pt.icosphere((x, 0, -3), 0.1, mat, 1) for x in (-1.0, 1.0)]
    parts += [pt.quad((-50, y, -60), (50, y, -60), (50, y, 40), (-50, y, 40), mat)
              for y in np.linspace(-5, -1, 20)]
    mixed = pt.concat_meshes(*parts)
    assert mixed.num_faces == 200 and tw.pack_tri_grid(mixed) is None
    assert tw.pack_tri_grid(pt.icosphere((0, 0, -3), 1.0, mat, 2)) is not None  # 320 faces


def _awkward_rays(pack):
    """Rays that start inside the grid, run along an axis (zero direction
    components), or pass through voxel corners and edges exactly."""
    gs = pack.static
    lo = np.array([gs.x0, gs.y0, gs.z0], np.float32)
    c = np.float32(gs.cell)
    corners = lo + c * np.array([[3, 2, 4], [5, 1, 6], [7, 3, 2], [2, 2, 2]], np.float32)
    o, d = [], []
    for p in corners:
        for dd in ([1, 1, 1], [-1, 1, 0], [0, 0, -1], [0, 1, 0], [1, 0, 0], [-2, -1, 1]):
            o.append(p - 3 * c * np.array(dd, np.float32))  # outside, through the corner
            d.append(dd)
            o.append(p + np.float32(0.3) * c)  # inside a voxel
            d.append(dd)
    return np.array(o, np.float32), np.array(d, np.float32)


@pytest.mark.parametrize("sub", [2, 3])
def test_walk_matches_brute_fuzz(sub):
    """Seeded rays and awkward ones: where both hit, the walk's t is the
    brute t bit for bit (the same Möller-Trumbore operations); hits agree
    on at least 99.9% of rays (they agree on all of these)."""
    mesh = mesh_demo_scene(sub)
    pack = tw.pack_tri_grid(mesh)
    o, d = seeded_rays(2048, seed=sub)
    ao, ad = _awkward_rays(pack)
    o, d = torch.from_numpy(np.concatenate([o, ao])), torch.from_numpy(np.concatenate([d, ad]))
    counts = {}
    t_w, id_w, hit_w = tw.tri_grid_nearest_hit(pack, mesh, o, d, counts=counts)
    t_b, id_b = pt.brute_nearest(o, d, mesh.v0, mesh.e1, mesh.e2)
    hit_b = t_b < pt.HIT_CUT
    assert float((hit_w == hit_b).float().mean()) >= 0.999
    both = hit_w & hit_b
    assert torch.equal(t_w[both], t_b[both])
    assert float((id_w[both] == id_b[both]).float().mean()) >= 0.999
    c = {k: int(v) for k, v in counts.items()}
    assert c["global_tests"] == 2 * o.shape[0]
    assert 0 < c["walks"] <= o.shape[0] <= c["voxel_visits"]
    assert 0 < c["face_tests"] < o.shape[0] * (mesh.num_faces - 2)


@pytest.mark.parametrize("sub", [2, 3])
def test_plain_grid_render_matches_jax(sub):
    """The grid plain version against JAX render_image(mesh.nearest_hit) at
    tests/test_tri_worklist.py's frame (64x36, 4 spp, 4 bounces, seed 7):
    RMSE < 1.5e-3 and rays exact, as the JAX grid kernel is held there."""
    kw = dict(width=64, height=36, spp=4, max_bounces=4, seed=7)
    jmesh = j_demo_mesh(sub)
    jcam = JCamera.look_at(DEMO_EYE, DEMO_AT, vfov_degrees=45.0, aspect_ratio=64 / 36)
    ref, ref_rays = j_integrator.render_image(jmesh.nearest_hit, jcam, **kw)
    packed = tm.pack_mesh(port_mesh(jmesh))
    assert packed.mode == "grid"
    img, rays = tm.render_image_mesh_kernel(packed, port_camera(jcam), **kw)
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - img.numpy()) ** 2)))
    assert rmse < 1.5e-3, rmse
    assert int(rays) == int(ref_rays)
