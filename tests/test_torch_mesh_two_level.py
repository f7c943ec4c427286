"""The two-level walk of the mesh grid (kernels/tri_worklist.py,
``tri_grid_nearest_hit(two_level=True)``: the plain version of the mesh
kernel's walk over a grid with a coarse level), on the CPU at small sizes:
against the flat walk on the path segments of small frames of the
15,362- and 102,402-face meshes (the same nearest hit and the same
triangle tests ray for ray, in fewer turns), on awkward rays (flat axes,
origins inside occupied blocks, rays that leave a skipped block at or near
its edges and corners, grids whose dims are not multiples of the coarse
block, exits through the grid's far faces), on NEE's shadow rays, and the
coarse level's block rule, bits and counts.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import tri_worklist as tw
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import mesh_demo_scene, mesh_night_scene
from csgrenderer_tpu_torch.render.trimesh import concat_meshes, quad
from csgrenderer_tpu_torch.scene import Material
from test_torch_trimesh import seeded_rays


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MESHES = {  # the mesh, the cell it is packed at (None: the packer's), its coarse block edge
    # on a finer grid than the packer's 65 x 27 x 43 (f = 1, which has no
    # coarse level): 127 x 54 x 86, f = 2
    "15k": (lambda: mesh_demo_scene(4), 0.03, 8),
    "102k": (lambda: mesh_demo_scene(5, 5), None, 8),
}
CAM = dict(eye=(0.0, 1.6, 2.2), at=(0.0, 0.7, -2.6))


@pytest.fixture(scope="module")
def packs():
    """name -> PackedMesh of MESHES, built once (the 102,402-face mesh packs
    in about a second)."""
    return {name: tm.pack_mesh(make(), cell=cell) for name, (make, cell, _) in MESHES.items()}


def _camera(width, height):
    return Camera.look_at(CAM["eye"], CAM["at"], vfov_degrees=45.0, aspect_ratio=width / height)


def _frame_segments(packed, monkeypatch, **frame):
    """Origins and directions of every segment a plain frame walks, path
    segments and shadow rays, in the order they were walked; and the
    frame's counts."""
    walked = []
    walk = tm.tri_grid_nearest_hit

    def recorded(pack, mesh, o, d, *args, **kw):
        walked.append((o.clone(), d.clone()))
        return walk(pack, mesh, o, d, *args, **kw)

    monkeypatch.setattr(tm, "tri_grid_nearest_hit", recorded)
    counts = {}
    tm.render_image_mesh_plain(packed, _camera(frame["width"], frame["height"]), counts=counts,
                               **frame)
    monkeypatch.undo()
    return torch.cat([o for o, _ in walked]), torch.cat([d for _, d in walked]), counts


def _walk(packed, o, d, two_level):
    counts = {}
    t, ids, _ = tw.tri_grid_nearest_hit(packed.grid, packed.mesh, o, d, counts=counts,
                                        two_level=two_level)
    return t, ids, {k: int(v) for k, v in counts.items()}


def _assert_same_walks(packed, o, d, subsets=16):
    """The two-level walk's nearest (t, id) equal the flat walk's ray for
    ray, and so do its triangle tests: their sums over every one of
    ``subsets`` seeded random halves of the rays are equal, and a ray whose
    count differed would make a random half's sums differ with probability
    1/2, so all of them agree only if the counts agree ray for ray (but
    with probability 2**-subsets). Returns the two walks' counts."""
    t, ids, flat = _walk(packed, o, d, False)
    t2, ids2, two = _walk(packed, o, d, True)
    assert torch.equal(t, t2) and torch.equal(ids, ids2)
    assert two["face_tests"] == flat["face_tests"] and two["walks"] == flat["walks"]
    gen = torch.Generator().manual_seed(26)
    for _ in range(subsets):
        half = torch.nonzero(torch.rand(o.shape[0], generator=gen) < 0.5)[:, 0]
        assert (_walk(packed, o[half], d[half], False)[2].get("face_tests", 0)
                == _walk(packed, o[half], d[half], True)[2].get("face_tests", 0))
    return flat, two


@pytest.mark.parametrize("name", sorted(MESHES))
def test_the_two_level_walk_tests_the_flat_walks_faces_in_fewer_turns(packs, monkeypatch, name):
    """On every segment of a 64x36, 1-spp, 6-bounce plain frame (the
    two-level walk, as the kernel walks a grid with a coarse level), the
    two-level walk finds the flat walk's nearest hit and tests its faces
    ray for ray; it skips coarse blocks and takes fewer turns (fine visits
    and skips) than the flat walk's visits."""
    packed = packs[name]
    assert packed.grid.static.coarse_block == MESHES[name][2]
    o, d, counts = _frame_segments(packed, monkeypatch, width=64, height=36, spp=1,
                                   max_bounces=6, seed=2)
    assert int(counts["coarse_skips"]) > 0
    flat, two = _assert_same_walks(packed, o, d)
    turns = two["voxel_visits"] + two["coarse_skips"]
    assert two["coarse_skips"] > 0 and "coarse_skips" not in flat
    assert turns < flat["voxel_visits"] / 2
    assert two["masked_visits"] < flat["masked_visits"]


def test_flat_axes(packs):
    """Rays parallel to one or two axes (a component 0 or under EPS_FLAT,
    either sign) keep their voxel along those axes through every skip, and
    walk to the flat walk's hits and tests."""
    packed = packs["102k"]
    o, d = (torch.from_numpy(x) for x in seeded_rays(256, seed=7))
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.choice([0.0, 1e-13, -1e-13, 5e-13], size=(256, 3))
                            .astype(np.float32))
    for axes in ((0,), (1,), (2,), (0, 1), (1, 2), (0, 2)):
        dd = d.clone()
        for ax in axes:
            dd[:, ax] = flat[:, ax]
        _assert_same_walks(packed, o, dd, subsets=4)
    walked = _walk(packed, o, torch.tensor([[0.0, 0.0, -1.0]]).expand_as(o), True)[2]
    assert walked["coarse_skips"] > 0


def test_origins_inside_occupied_blocks(packs):
    """Rays that start on the mesh (just off a face, as a bounce does) in an
    occupied coarse block, aimed every way."""
    packed = packs["15k"]
    mesh, gs = packed.mesh, packed.grid.static
    rng = np.random.default_rng(11)
    faces = torch.from_numpy(rng.choice(mesh.num_faces - 2, 1024, replace=False))
    o = (mesh.v0[faces] + mesh.e1[faces] / 3 + mesh.e2[faces] / 3
         + 1e-3 * mesh.face_normals[faces])
    d = torch.from_numpy(rng.normal(size=(1024, 3)).astype(np.float32))
    p = gs.f32_params()
    i = ((o - torch.tensor(p["lo"])) * float(p["inv_cell"])).floor().to(torch.int64)
    c = gs.coarse_shift
    b = ((i[:, 0] >> c) * gs.coarse_dims[1] + (i[:, 1] >> c)) * gs.coarse_dims[2] + (i[:, 2] >> c)
    words = packed.grid.coarse_mask.to(torch.int64)
    assert bool((((words[b >> 5] >> (b & 31)) & 1) == 1).all())
    _assert_same_walks(packed, o, d, subsets=8)


def test_grids_not_a_multiple_of_the_coarse_block_and_far_face_exits():
    """Grids of other cells, with a coarse level and dims no multiple of C,
    so the last coarse block along an axis hangs past the grid's far face;
    rays from inside the grid out through each far face (and the near
    ones) walk to the flat walk's hits and tests."""
    mesh = mesh_demo_scene(3)
    for cell in (0.0293, 0.0251):
        pack = tw.pack_tri_grid(mesh, cell)
        gs = pack.static
        assert gs.coarse_block and any(n % gs.coarse_block for n in gs.dims)
        packed = SimpleNamespace(grid=pack, mesh=mesh)
        p = gs.f32_params()
        lo, hi = np.array(p["lo"], np.float32), np.array(p["hi"], np.float32)
        rng = np.random.default_rng(5)
        o = rng.uniform(lo, hi, (600, 3)).astype(np.float32)
        d = rng.normal(size=(600, 3)).astype(np.float32)
        d[:300] = np.abs(d[:300])  # toward the far faces
        _assert_same_walks(packed, torch.from_numpy(o), torch.from_numpy(d), subsets=6)


def _walk_flat(monkeypatch):
    """Make the plain render walk every grid flat."""
    walk = tm.tri_grid_nearest_hit
    monkeypatch.setattr(tm, "tri_grid_nearest_hit",
                        lambda *args, **kw: walk(*args, **{**kw, "two_level": False}))


def test_nee_shadow_rays_reach_the_flat_walks_decisions(packs, monkeypatch):
    """NEE on the 15,362-face mesh under a lamp: the frame's shadow rays
    (walked as the kernel walks them, in two levels) are occluded or clear
    as under the flat walk: the same image, segments, shadow rays and clear
    shadow rays."""
    mesh = concat_meshes(packs["15k"].mesh, quad(
        (-0.8, 2.6, -3.6), (0.8, 2.6, -3.6), (0.8, 2.6, -2.4), (-0.8, 2.6, -2.4),
        Material.emissive((12.0, 10.0, 8.0))))
    packed = tm.pack_mesh(mesh, cell=MESHES["15k"][1])
    assert packed.grid.static.coarse_block
    frame = dict(width=32, height=18, spp=1, max_bounces=4, seed=5, sky="black", nee=True)
    cam = _camera(32, 18)
    two_counts = {}
    two = tm.render_image_mesh_plain(packed, cam, counts=two_counts, **frame)
    _walk_flat(monkeypatch)
    flat_counts = {}
    flat = tm.render_image_mesh_plain(packed, cam, counts=flat_counts, **frame)
    assert torch.equal(two[0], flat[0]) and int(two[1]) == int(flat[1])
    for key in ("shadow_rays", "shadow_clear", "tri_tests"):
        assert int(two_counts[key]) == int(flat_counts[key]) > 0, key
    assert int(two_counts["coarse_skips"]) > 0 == int(flat_counts["coarse_skips"])


H100_TABLE_LIMIT = 232_448 - 16  # an H100's opt-in shared memory a block, less the mbarrier


def test_coarse_block_rule():
    """C = COARSE_FACTOR x f where f > 1: 8 for the 102,402-face mesh's 257
    x 67 x 193 grid (f = 2; a 33 x 9 x 25 mask, 7,425 bits in 944 bytes);
    none (C = 0, coarse_shift 0) for the 15,362-face mesh's 65 x 27 x 43
    (f = 1), whose fine mask alone is held to MASK_BUDGET, as before the
    coarse level. Both masks fit MASK_BUDGET together, each coarse
    coordinate is i >> coarse_shift = i // C, and every grid with a coarse
    level has more CSR offsets than an H100 can stage, so the kernel reads
    its tables from global memory and walks it in two levels."""
    dims = (257, 67, 193)
    assert tw.coarse_block(dims) == 8 and tw.mask_block(dims) == 2
    gs = tw.TriGridStatic(*dims, 0.0, 0.0, 0.0, 0.1)
    assert gs.coarse_dims == (33, 9, 25) and tw.mask_bytes(dims, 8) == 944
    small = tw.TriGridStatic(65, 27, 43, 0.0, 0.0, 0.0, 0.1)
    assert small.coarse_block == 0 and small.coarse_shift == 0 == sum(small.coarse_dims)
    assert tw.mask_block((79, 80, 80)) == 1 and tw.mask_block((80, 80, 80)) == 2
    for dims in ((257, 67, 193), (65, 27, 43), (1025, 700, 23), (256, 256, 256), (7, 1, 1),
                 (79, 80, 80), (80, 80, 80), (127, 54, 86)):
        f, c = tw.mask_block(dims), tw.coarse_block(dims)
        gs = tw.TriGridStatic(*dims, 0.0, 0.0, 0.0, 0.1)
        if f == 1:
            assert c == 0 and tw.mask_bytes(dims, f) <= tw.MASK_BUDGET
            continue
        assert c == tw.COARSE_FACTOR * f and c & (c - 1) == 0
        assert tw.mask_bytes(dims, f) + tw.mask_bytes(dims, c) <= tw.MASK_BUDGET
        assert 4 * (gs.n_voxels + 1) > H100_TABLE_LIMIT
        i = np.arange(max(dims), dtype=np.int64)
        assert 1 << gs.coarse_shift == c and np.array_equal(i >> gs.coarse_shift, i // c)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_coarse_mask_bits_and_the_staged_block(packs, name):
    """Every coarse block's bit is set iff a voxel of the block has a
    non-empty list (blocks past the far faces included), and the words past
    the last block are zero; the kernel stages the fine mask, then the
    coarse one at a 16-byte aligned offset, as one block."""
    packed = packs[name]
    pack = packed.grid
    gs = pack.static
    c = gs.coarse_block
    assert c == MESHES[name][2]
    cx, cy, cz = gs.coarse_dims
    assert (cx, cy, cz) == tuple(-(-n // c) for n in gs.dims)
    lens = (pack.offsets[1:] - pack.offsets[:-1]).numpy()
    vox = np.nonzero(lens)[0]
    ix, iy, iz = vox // (gs.ny * gs.nz), (vox // gs.nz) % gs.ny, vox % gs.nz
    mask = pack.coarse_mask
    assert mask.dtype == torch.uint32 and mask.numel() * 4 == tw.mask_bytes(gs.dims, c)
    want = np.zeros(mask.numel() * 32, np.uint8)
    want[((ix // c) * cy + iy // c) * cz + iz // c] = 1
    got = np.unpackbits(mask.view(torch.uint8).numpy(), bitorder="little")
    assert np.array_equal(got, want) and 0 < got.sum() < cx * cy * cz
    assert torch.equal(packed.masks, torch.cat([pack.mask, pack.coarse_mask]))
    assert pack.mask.numel() % 4 == 0 and packed.masks.data_ptr() % 16 == 0


def test_plain_render_walks_in_two_levels_where_the_kernel_would(packs, monkeypatch):
    """``render_image_mesh_plain`` walks a grid in two levels where it has
    a coarse level, as the kernel does: the 15,362-face mesh on a grid of f
    = 2 skips, and renders the flat walk's image and tests. The packer's
    own grid of that mesh (65 x 27 x 43, f = 1, its tables read from
    global memory) and meshnight's (staged) have none: their walks are
    flat, with no coarse word staged and no skip; brute mode skips
    nothing."""
    cam = Camera.look_at((0, 1.8, 2.4), (0.0, 0.7, -2.6), vfov_degrees=45.0, aspect_ratio=2.0)
    frame = dict(width=24, height=12, spp=1, max_bounces=4, seed=3, sky="black")
    two, flat = {}, {}
    img, rays = tm.render_image_mesh_plain(packs["15k"], cam, counts=two, **frame)
    with monkeypatch.context() as m:
        _walk_flat(m)
        img2, rays2 = tm.render_image_mesh_plain(packs["15k"], cam, counts=flat, **frame)
    assert torch.equal(img, img2) and int(rays) == int(rays2)
    assert int(two["tri_tests"]) == int(flat["tri_tests"])
    assert int(two["coarse_skips"]) > 0 == int(flat["coarse_skips"])
    for packed in (tm.pack_mesh(mesh_demo_scene(4)), tm.pack_mesh(mesh_night_scene())):
        grid = packed.grid
        assert grid.static.coarse_block == 0 and grid.coarse_mask.numel() == 0
        assert torch.equal(packed.masks, grid.mask)
        counts = {}
        tm.render_image_mesh_plain(packed, cam, counts=counts, **frame)
        assert int(counts["coarse_skips"]) == 0 < int(counts["tri_tests"])
    brute = {}
    tm.render_image_mesh_plain(tm.pack_mesh(mesh_demo_scene(1), False), cam, counts=brute,
                               **frame)
    assert int(brute["coarse_skips"]) == 0 and int(brute["tri_tests"]) > 0


def test_rays_leaving_skipped_blocks_at_their_edges_and_corners(packs):
    """Rays from inside empty coarse blocks aimed at a point of a far face
    of the block whose other coordinates lie on the block's far edges or
    corner or on a voxel boundary inside the block, on it and a rounding
    or so to either side, so that they leave the block across two or three
    far faces at once or cross a side axis's boundary as they leave: the
    two-level walk finds the flat walk's nearest hit ray for ray, and
    skips."""
    packed = packs["15k"]
    gs, pack = packed.grid.static, packed.grid
    c, (cx, cy, cz) = gs.coarse_block, gs.coarse_dims
    p = gs.f32_params()
    lo, cell = np.array(p["lo"], np.float64), float(p["cell"])
    bits = np.unpackbits(pack.coarse_mask.view(torch.uint8).numpy(), bitorder="little")
    blocks = np.stack(np.unravel_index(np.arange(cx * cy * cz), (cx, cy, cz)), axis=1)
    inside = (blocks * c + c <= np.array(gs.dims)).all(axis=1)  # whole blocks in the grid
    empty = blocks[inside & (bits[:cx * cy * cz] == 0)]
    rng = np.random.default_rng(26)
    n = 4000
    b = empty[rng.integers(0, len(empty), n)]
    o = lo + (b * c + rng.uniform(0.15, 0.85, (n, 3)) * c) * cell
    s = rng.choice([-1, 1], (n, 3))
    far = lo + (b * c + np.where(s > 0, c, 0)) * cell  # the far corner along s
    inner = lo + (b * c + rng.integers(1, c, (n, 3))) * cell  # a voxel boundary in the block
    target = np.where(rng.random((n, 3)) < 0.5, far, inner)
    exit_axis = rng.integers(0, 3, n)
    target[np.arange(n), exit_axis] = far[np.arange(n), exit_axis]
    target += rng.choice([0.0, 1e-7, -1e-7, 1e-6, -1e-6], (n, 3)) * cell
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    t, ids, _ = _walk(packed, o, d, False)
    t2, ids2, two = _walk(packed, o, d, True)
    assert torch.equal(t, t2) and torch.equal(ids, ids2)
    assert two["coarse_skips"] >= n and int((t < tw.HIT_CUT).sum()) > n // 2


def test_a_skips_side_axes_take_no_crossing_at_or_past_its_exit():
    """``crossings_before`` (the kernel's follow_axis) on axes whose k-th
    crossing falls at a skip's exit and up to three f32 roundings either
    side of it: rounded up alone, the count takes a crossing at or past the
    exit on some of them; it never does, in the walk's f32 sums nor in
    f64, and is never more than one short; a flat axis takes none."""
    rng = np.random.default_rng(7)
    n = 200_000
    cell = np.float32(0.02421875)
    inv_cell = np.float32(1.0 / cell)
    d = (rng.uniform(0.02, 1.0, n) * rng.choice([-1, 1], n)).astype(np.float32)
    td = np.abs(cell / d).astype(np.float32)
    tm = rng.uniform(0.0, 6.0, n).astype(np.float32)
    t_exit = (tm + rng.integers(0, 8, n).astype(np.float32) * td).astype(np.float32)
    for ulps in rng.integers(-3, 4, (3, n)):
        t_exit = np.where(ulps > 0, np.nextafter(t_exit, np.float32(np.inf)),
                          np.where(ulps < 0, np.nextafter(t_exit, np.float32(-np.inf)), t_exit))
    left = rng.integers(0, 8, n)
    m = tw.crossings_before(*(torch.from_numpy(x) for x in (t_exit, tm, td, d)), float(inv_cell),
                            torch.from_numpy(left)).numpy()
    j = np.arange(8)[None]
    before32 = (tm[:, None] + j.astype(np.float32) * td[:, None]) < t_exit[:, None]
    before64 = (tm[:, None].astype(np.float64) + j * td[:, None].astype(np.float64)
                < t_exit[:, None].astype(np.float64))
    for before in (before32, before64):
        want = (before & (j < left[:, None])).sum(axis=1)
        assert (m <= want).all() and (m >= want - 1).all()
    rounded_up = np.minimum(np.ceil((t_exit - tm) * (np.abs(d) * inv_cell)), left)
    assert (rounded_up > (before32 & (j < left[:, None])).sum(axis=1)).sum() > 100
    assert (m == (before32 & (j < left[:, None])).sum(axis=1)).mean() > 0.999
    big = torch.full((4,), tw.BIG)
    flat = tw.crossings_before(torch.full((4,), 3.0), big, big,
                               torch.tensor([0.0, 1e-13, -1e-13, 0.0]), float(inv_cell),
                               torch.full((4,), 7))
    assert (flat == 0).all()
