"""The port's voxel-grid packer and plain walk (kernels/tri_worklist.py),
on the CPU: the SAT test against the JAX package's, the packer's
invariants, the walk against brute Möller-Trumbore on seeded and awkward
rays, and the plain grid render against JAX
``render_image(mesh.nearest_hit)`` at the bound of
tests/test_tri_worklist.py (RMSE < 1.5e-3, rays exact); the occupancy
mask's bits against the voxel lists, its block-edge rule, and the plain
walk's count of the visits it answers.
"""

import dataclasses

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


# --- the occupancy mask ------------------------------------------------------

MASK_MESHES = {  # mesh, MASK_BUDGET (None: the module's), block edge
    "demo7-102k": (lambda: mesh_demo_scene(5, 5), None, 2),
    "demo-3842": (lambda: mesh_demo_scene(3), None, 1),
    "demo-3842-coarse": (lambda: mesh_demo_scene(3), 128, 4),
}


@pytest.fixture(scope="module")
def mask_packs():
    """The packs of MASK_MESHES, built once (the 102,402-face mesh packs in
    about 1.5 s)."""
    return {}


def _mask_pack(mask_packs, monkeypatch, name):
    make, budget, _ = MASK_MESHES[name]
    if budget is not None:
        monkeypatch.setattr(tw, "MASK_BUDGET", budget)
    if name not in mask_packs:
        mesh = make()
        mask_packs[name] = (mesh, tw.pack_tri_grid(mesh))
    return mask_packs[name]


@pytest.mark.parametrize("name", sorted(MASK_MESHES))
def test_occupancy_mask_bits(mask_packs, monkeypatch, name):
    """Every block's bit is set iff some voxel of the block has a non-empty
    list, blocks that reach past the grid's far faces included; the words
    past the last block are zero; the mask is uint32, 16-byte aligned, a
    multiple of 16 bytes, within the budget."""
    mesh, pack = _mask_pack(mask_packs, monkeypatch, name)
    gs = pack.static
    f = gs.mask_block
    assert f == MASK_MESHES[name][2]
    mx, my, mz = gs.mask_dims
    assert (mx, my, mz) == tuple(-(-n // f) for n in gs.dims)
    if f > 1:  # some blocks hang over a far face of the grid
        assert any(n % f for n in gs.dims)
    mask = pack.mask
    assert mask.dtype == torch.uint32 and mask.data_ptr() % 16 == 0
    assert mask.numel() * 4 == tw.mask_bytes(gs.dims, f) <= tw.MASK_BUDGET
    assert mask.numel() % 4 == 0
    # expected from the voxel lists directly, one non-empty voxel at a time
    lens = (pack.offsets[1:] - pack.offsets[:-1]).numpy()
    vox = np.nonzero(lens)[0]
    ix, iy, iz = vox // (gs.ny * gs.nz), (vox // gs.nz) % gs.ny, vox % gs.nz
    want = np.zeros(mask.numel() * 32, np.uint8)
    want[((ix // f) * my + iy // f) * mz + iz // f] = 1
    got = np.unpackbits(mask.view(torch.uint8).numpy(), bitorder="little")
    assert np.array_equal(got, want)
    assert got[mx * my * mz:].sum() == 0
    assert 0 < got.sum() < mx * my * mz


def test_mask_block_rule():
    """The finest power-of-two block edge whose mask fits MASK_BUDGET: 2
    for the 102,402-face mesh's 257 x 67 x 193 grid (415,424 bytes at 1,
    53,184 at 2, 6,784 at 4), 1 for grids whose every voxel fits a bit;
    each block coordinate is i >> mask_shift = i // f over the whole
    grid."""
    dims = (257, 67, 193)
    assert [tw.mask_bytes(dims, f) for f in (1, 2, 4)] == [415_424, 53_184, 6_784]
    assert tw.mask_block(dims) == 2
    assert tw.mask_block((65, 27, 43)) == 1  # the 15,362-face bench mesh
    for dims in ((257, 67, 193), (65, 27, 43), (1025, 700, 23), (256, 256, 256), (7, 1, 1)):
        f = tw.mask_block(dims)
        assert f & (f - 1) == 0 and tw.mask_bytes(dims, f) <= tw.MASK_BUDGET
        assert f == 1 or tw.mask_bytes(dims, f // 2) > tw.MASK_BUDGET
        gs = tw.TriGridStatic(*dims, 0.0, 0.0, 0.0, 0.1)
        i = np.arange(max(dims), dtype=np.int64)
        assert 1 << gs.mask_shift == f and np.array_equal(i >> gs.mask_shift, i // f)


@pytest.mark.parametrize("name", ["demo7-102k", "demo-3842-coarse"])
def test_plain_walk_counts_masked_visits(mask_packs, monkeypatch, name):
    """The plain walk's masked visits are visits to voxels of empty blocks:
    more than none on the demo 7 scene, at most its voxel visits; counting
    them changes nothing else. A mask of every bit set (no block empty)
    gives the same hits, voxel visits and face tests, and no masked
    visit."""
    mesh, pack = _mask_pack(mask_packs, monkeypatch, name)
    o, d = (torch.from_numpy(x) for x in seeded_rays(1024, seed=11))
    counts = {}
    t, ids, hit = tw.tri_grid_nearest_hit(pack, mesh, o, d, counts=counts)
    t0, ids0, hit0 = tw.tri_grid_nearest_hit(pack, mesh, o, d)
    assert torch.equal(t, t0) and torch.equal(ids, ids0) and torch.equal(hit, hit0)
    c = {k: int(v) for k, v in counts.items()}
    assert 0 < c["masked_visits"] <= c["voxel_visits"]
    full = dataclasses.replace(pack, mask=torch.full_like(pack.mask, 0xFFFFFFFF))
    unmasked = {}
    t1, ids1, _ = tw.tri_grid_nearest_hit(full, mesh, o, d, counts=unmasked)
    assert torch.equal(t, t1) and torch.equal(ids, ids1)
    u = {k: int(v) for k, v in unmasked.items()}
    assert u.pop("masked_visits") == 0
    assert u == {k: v for k, v in c.items() if k != "masked_visits"}


def test_plain_render_counts_the_path_segments_masked_visits(monkeypatch):
    """``render_image_mesh_plain(counts=)`` takes ``masked_visits`` from its
    path segments' walks alone, as the kernel counts them: with NEE on the
    meshnight scene, fewer than all its walks' (shadow rays' included);
    without NEE, all of them; in brute mode 0."""
    from csgrenderer_tpu_torch.camera import Camera
    from csgrenderer_tpu_torch.models import mesh_night_scene

    every = {}
    walk = tm.tri_grid_nearest_hit

    def counted_walk(*args, counts=None, **kw):
        mine = {}
        out = walk(*args, counts=mine, **kw)
        tw.add_count(every, "masked_visits", mine["masked_visits"])
        if counts is not None:
            for key, value in mine.items():
                tw.add_count(counts, key, value)
        return out

    monkeypatch.setattr(tm, "tri_grid_nearest_hit", counted_walk)
    cam = Camera.look_at((0, 1.8, 2.4), (0.0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=2.0)
    frame = dict(width=24, height=12, spp=1, max_bounces=4, seed=3, sky="black")
    packed = tm.pack_mesh(mesh_night_scene())
    for nee in (True, False):
        every.clear()
        counts = {}
        tm.render_image_mesh_plain(packed, cam, nee=nee, counts=counts, **frame)
        path, walks = int(counts["masked_visits"]), int(every["masked_visits"])
        assert 0 < path < walks if nee else 0 < path == walks
    brute = {}
    tm.render_image_mesh_plain(tm.pack_mesh(mesh_demo_scene(1), False), cam, counts=brute,
                               **frame)
    assert int(brute["masked_visits"]) == 0 and int(brute["tri_tests"]) > 0
