"""The triangle-mesh kernel: packing, the CUDA launch, and its plain version.

Twin of ``csgrenderer_tpu/kernels/trimesh_kernel.py`` (``pack_mesh``,
``render_image_mesh_pallas``). ``render_image_mesh_kernel`` renders a
``MeshScene`` in one of two modes, chosen as the JAX package chooses:
grid mode (the big faces brute-forced, then a per-ray 3D voxel DDA over
the CSR face lists of ``tri_worklist.pack_tri_grid``) for meshes the
packer grids, brute mode (every face against every ray) otherwise. The
JAX package's stream and HBM modes existed because a TPU core's VMEM
could not hold a big mesh's tables; here the grid's lists lie in device
memory at any size, so grid mode serves those meshes too.

Where the tensors lie decides what runs:

- on a CUDA device, the hand-written kernel ``csrc/trimesh_kernel.cu``
  (built for sm_90a at first use) is launched, or an error is raised;
- on the CPU, the plain torch version ``render_image_mesh_plain`` runs:
  ``render/integrator.render_image`` with the brute nearest hit, or with
  ``tri_worklist.tri_grid_nearest_hit`` in grid mode.

``nee=True`` adds next-event estimation toward the mesh's emissive faces
(``render/lights.py``, ``TriLights``): the kernel's NEE variant, or the
plain version with ``lights=``. Both count the Möller-Trumbore tests of
their path segments (the globals or every face, then the faces the walk
lists; shadow rays' tests are not counted), which ``counts`` takes under
``"tri_tests"``: the kernel adds them into a device word of its own, the
plain version takes them from its walk's counts (``global_tests +
face_tests``) or, in brute mode, as faces x segments. Beside them,
``"masked_visits"``: the voxel visits of the path segments' walks that the
grid's occupancy mask (``tri_worklist.occupancy_mask``) answers without a
load of the voxel's offsets; the kernel counts those its global-memory
walk makes (0 where it stages the tables, whose walk has no mask, and in
brute mode), the plain version those of its walk. And ``"coarse_skips"``:
the turns of those walks that jumped an empty block of the grid's coarse
mask. The kernel walks a grid that has a coarse level in two levels
(``tri_worklist`` module docstring; such a grid's tables are always read
from global memory), any other flat, and so does the plain version
(``tri_grid_nearest_hit(two_level=True)``): both count the same visits.
``LAUNCHES`` counts
kernel launches (``LAUNCHES_BY_MODE`` per mode: brute, grid, brute-nee,
grid-nee; ``LAUNCHES_BY_TABLES`` by where the launch read the tables a walk
reads: staged in shared memory, or global memory when
``PackedMesh.table_bytes`` exceeds ``table_limit``); only the launch site
adds to them.

A launch in grid mode without NEE over tables in global memory that is
handed ``counts`` may run the kernel's stats instantiation
(``build.stats_launch``: one such launch in ``build.STATS_EVERY`` while
the program's spans record): the same image and counts, and a block of
work counts (the first three of ``build.STATS_WORDS``: the segment loop's
and the voxel walk's warp turns and the walk's lane turns) that
``counts`` takes under ``"stats"``. The plain version's walk counts its
voxel visits (``"voxel_visits"``), the lane turns of the kernel's walk.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import Tensor

from ..render import integrator
from ..render.integrator import SKY_MODES, SurfaceHit
from ..render.lights import TriLights, extract_mesh_lights
from ..render.trimesh import MeshScene
from ..utils import profiling
from . import build
from .megakernel import CAM_SIZE, JITTER_ON_CPU_ONLY, pack_camera
from .tri_worklist import TriGridPack, pack_tri_grid, tri_grid_nearest_hit
from .worklist import add_count

FACE_WORDS = 20  # floats per face record: v0, e1, e2, unit normal, kind, param, albedo, pad
MT_WORDS = 12  # floats per MT record: v0, e1, e2, pad, as (v0, e1x) (e1yz, e2xy) (e2z, pad)
LAMP_WORDS = 16  # floats per lamp record: v0, e1, e2, emitted rgb, unit normal, area
KERNEL_SOURCE = "trimesh_kernel"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"brute": 0, "grid": 0, "brute-nee": 0, "grid-nee": 0}
# where a launch read the MT table and the grid's lists: staged in each
# CTA's shared memory, or from global memory (tables over the device's limit)
LAUNCHES_BY_TABLES = {"shared": 0, "global": 0}
build.count_launches(__name__, "LAUNCHES", "LAUNCHES_BY_MODE", "LAUNCHES_BY_TABLES")
_NO_LAMPS = "nee=True but the mesh has no emissive faces"


@dataclass(frozen=True)
class PackedMesh:
    """A mesh prepared for the kernel (once per mesh, on its device).

    ``faces`` holds, per face, five float4: (v0x, v0y, v0z, e1x),
    (e1y, e1z, e2x, e2y), (e2z, nx, ny, nz), (kind, param, albedo r, g),
    (albedo b, 0, 0, 0), in the mesh's own face order; the unit normal is
    the plain version's ``face_normals``, made here once, so the kernel
    never derives one. ``grid`` is the voxel grid in grid mode, None in
    brute mode. ``lamps`` is the NEE lamp table of the JAX layout
    (``trimesh_kernel.py:771-777``): one row (v0, e1, e2, emitted rgb,
    unit normal, area) per emissive face, as ``extract_mesh_lights``
    gives them; None when the mesh has no emissive face.

    ``tables`` is what a walk reads, in one block the kernel stages in
    shared memory when it fits (``table_layout``): the MT table ``mt``
    ([F, 12] f32: v0, e1, e2 and a pad word, the floats of ``faces``
    columns 0-8), then in grid mode the CSR offsets, face ids and globals
    as int32, each at a 16-byte aligned offset and padded to 16 bytes.
    The grid's occupancy masks (``masks``: ``grid.mask``, then
    ``grid.coarse_mask`` at byte ``mask_bytes``), which the kernel stages
    in place of the tables when it reads them from global memory, are apart
    from this block, so ``table_bytes`` and the staged-or-global choice do
    not depend on them.
    """

    mesh: MeshScene
    faces: Tensor  # [F, 20] f32
    grid: TriGridPack | None
    lamps: Tensor | None  # [n_lights, 16] f32
    tables: Tensor  # [table_bytes / 4] f32 (int32 words in grid mode's sections)
    masks: Tensor | None  # grid mode: [W + Wc] uint32, the two masks' words; brute: None

    @property
    def mode(self) -> str:
        return "brute" if self.grid is None else "grid"

    @property
    def device(self) -> torch.device:
        return self.faces.device

    @property
    def normals(self) -> Tensor:
        return self.faces[:, 9:12]

    @property
    def mt(self) -> Tensor:
        """[F, 12] f32: each face's MT record (a view of ``tables``)."""
        f = self.mesh.num_faces
        return self.tables[:f * MT_WORDS].view(f, MT_WORDS)

    @property
    def table_bytes(self) -> int:
        """The bytes a CTA stages in shared memory (a multiple of 16)."""
        return self.tables.numel() * 4

    @property
    def layout(self) -> TableLayout:
        return table_layout(self.mesh.num_faces, self.grid)

    @property
    def lights(self) -> TriLights | None:
        """The lamp table as the plain version's ``TriLights``."""
        if self.lamps is None:
            return None
        t = self.lamps
        return TriLights(t[:, 0:3], t[:, 3:6], t[:, 6:9], t[:, 9:12], t[:, 12:15], t[:, 15])

    def to(self, device) -> "PackedMesh":
        grid = None if self.grid is None else self.grid.to(device)
        lamps = None if self.lamps is None else self.lamps.to(device)
        masks = None if self.masks is None else self.masks.to(device)
        return PackedMesh(self.mesh.to(device), self.faces.to(device), grid, lamps,
                          self.tables.to(device), masks)


class TableLayout(NamedTuple):
    """Byte offsets of the grid's sections in ``PackedMesh.tables`` (-1 in
    brute mode) and the block's length."""

    off_at: int
    ids_at: int
    glob_at: int
    nbytes: int


def _pad16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def table_layout(n_faces: int, grid: TriGridPack | None) -> TableLayout:
    """Where ``PackedMesh.tables`` holds what: the [F, 3] float4 MT table
    from byte 0, then (grid mode) the [V + 1] offsets, the [P] face ids and
    the [G] globals, each padded to a multiple of 16 bytes."""
    at = n_faces * MT_WORDS * 4
    if grid is None:
        return TableLayout(-1, -1, -1, at)
    off_at = at
    ids_at = off_at + _pad16(4 * grid.offsets.numel())
    glob_at = ids_at + _pad16(4 * grid.face_ids.numel())
    return TableLayout(off_at, ids_at, glob_at, glob_at + _pad16(4 * grid.n_globals))


def _face_table(mesh: MeshScene) -> Tensor:
    tab = torch.zeros((mesh.num_faces, FACE_WORDS), dtype=torch.float32, device=mesh.device)
    tab[:, 0:3] = mesh.v0
    tab[:, 3:6] = mesh.e1
    tab[:, 6:9] = mesh.e2
    tab[:, 9:12] = mesh.face_normals
    tab[:, 12] = mesh.mat_kind.to(torch.float32)
    tab[:, 13] = mesh.mat_param
    tab[:, 14:17] = mesh.albedo
    return tab


def _tables(mesh: MeshScene, faces: Tensor, grid: TriGridPack | None) -> Tensor:
    lay = table_layout(mesh.num_faces, grid)
    tab = torch.zeros(lay.nbytes // 4, dtype=torch.float32, device=mesh.device)
    f = mesh.num_faces
    tab[:f * MT_WORDS].view(f, MT_WORDS)[:, 0:9] = faces[:, 0:9]
    if grid is not None:
        words = tab.view(torch.int32)
        for at, t in ((lay.off_at, grid.offsets), (lay.ids_at, grid.face_ids),
                      (lay.glob_at, grid.globals_idx)):
            words[at // 4:at // 4 + t.numel()] = t
    return tab


def _lamp_table(mesh: MeshScene) -> Tensor | None:
    lights = extract_mesh_lights(mesh)
    if lights is None:
        return None
    tab = torch.zeros((lights.num_lights, LAMP_WORDS), dtype=torch.float32, device=mesh.device)
    tab[:, 0:3] = lights.v0
    tab[:, 3:6] = lights.e1
    tab[:, 6:9] = lights.e2
    tab[:, 9:12] = lights.emit
    tab[:, 12:15] = lights.normal
    tab[:, 15] = lights.area
    return tab


def pack_mesh(mesh: MeshScene, worklist: bool | str = "auto", cell: float | None = None
              ) -> PackedMesh:
    """Choose the mode and build the kernel's tables on the mesh's device.

    ``worklist``: "auto" takes grid mode when ``pack_tri_grid`` grids the
    mesh (192 faces or more); True forces grid mode (and raises if the
    mesh is not griddable); False forces brute mode. The JAX package's
    "stream" and "tiered" are TPU gather modes and raise. ``cell``: the
    grid's voxel edge (``pack_tri_grid``); None takes its occupancy rule.
    """
    if worklist in ("stream", "tiered"):
        raise ValueError(f"worklist={worklist!r} is a TPU gather mode with no counterpart here: "
                         "grid mode keeps the voxel lists in device memory at any mesh size, "
                         "so use 'auto' or True")
    if worklist not in ("auto", True, False):
        raise ValueError(f"worklist must be 'auto', True or False, got {worklist!r}")
    with profiling.span("scene.pack"):
        grid = None
        if worklist in (True, "auto"):
            grid = pack_tri_grid(mesh, cell)
            if grid is None and worklist is True:
                raise ValueError("worklist=True but the mesh is not griddable "
                                 "(under 192 faces to grid)")
        faces = _face_table(mesh)
        masks = None if grid is None else torch.cat([grid.mask, grid.coarse_mask])
        return PackedMesh(mesh, faces, grid, _lamp_table(mesh), _tables(mesh, faces, grid),
                          masks)


def _grid_hit_fn(packed: PackedMesh, counts: dict | None):
    def hit_fn(o: Tensor, d: Tensor) -> SurfaceHit:
        batch = o.shape[:-1]
        flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, idx, _ = tri_grid_nearest_hit(packed.grid, packed.mesh, flat_o, flat_d, counts=counts,
                                         two_level=True)
        h = packed.mesh.surface_hit(flat_d, t, idx, packed.normals)
        return SurfaceHit(*(x.reshape(batch + x.shape[1:]) for x in h))

    return hit_fn


def render_image_mesh_plain(
    packed: PackedMesh,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    lens: bool = False,
    sample_offset: int = 0,
    nee: bool = False,
    counts: dict | None = None,
    rows: int | None = None,
    row_offset: int = 0,
    jitter: bool = True,
    sample_batch: int = 1,
) -> tuple[Tensor, Tensor]:
    """The plain torch version of the kernel, on any device. With ``nee``
    it renders with the packed lamp table as ``lights=``; ``counts`` as in
    ``integrator.trace_paths``, plus, in grid mode, the walk's work
    (``tri_worklist.tri_grid_nearest_hit``, shadow rays included) but its
    masked visits and coarse skips, plus the path segments' triangle tests
    (``"tri_tests"``: ``global_tests + face_tests`` of the path segments'
    walks, or faces x segments in brute mode), masked visits
    (``"masked_visits"``: 0 in brute mode) and coarse skips
    (``"coarse_skips"``: 0 in brute mode and where the walk is flat),
    shadow rays included in none; ``rows``, ``row_offset``, ``jitter`` and
    ``sample_batch`` as in ``integrator.render_image``. The grid is walked
    in two levels where it has a coarse level, as the kernel walks it."""
    if nee and packed.lamps is None:
        raise ValueError(_NO_LAMPS)
    # the path segments' walks are counted apart from the shadow rays'
    path_work = {} if counts is not None and packed.grid is not None else None
    shadow_work = {} if path_work is not None and nee else None
    shadow_hit_fn = None
    if packed.grid is None:
        hit_fn = functools.partial(packed.mesh.nearest_hit, normals=packed.normals)
    else:
        hit_fn = _grid_hit_fn(packed, path_work)
        shadow_hit_fn = _grid_hit_fn(packed, shadow_work) if nee else None
    image, rays = integrator.render_image(
        hit_fn, camera, width, height, spp=spp, max_bounces=max_bounces,
        seed=seed, sky=sky, jitter=jitter, lens=lens, sample_offset=sample_offset,
        lights=packed.lights if nee else None, counts=counts, rows=rows, row_offset=row_offset,
        sample_batch=sample_batch, shadow_hit_fn=shadow_hit_fn,
    )
    if counts is not None:
        masked = skips = 0
        if path_work is None:
            tests = rays * packed.mesh.num_faces
        else:
            for work in (path_work, shadow_work or {}):
                for key, value in work.items():
                    if key not in ("masked_visits", "coarse_skips"):
                        add_count(counts, key, value)
            tests = path_work.get("global_tests", 0) + path_work.get("face_tests", 0)
            masked = path_work.get("masked_visits", 0)
            skips = path_work.get("coarse_skips", 0)
        for key, value in (("tri_tests", tests), ("masked_visits", masked),
                           ("coarse_skips", skips)):
            add_count(counts, key, torch.as_tensor(value, dtype=torch.int64, device=rays.device))
    return image, rays


_VP, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = ((_VP, _VP, _VP) + (_I,) * 9 + (_F,) * 8 + (_VP,) + (_I,) * 8 + (_VP,) + (_I,) * 7
             + (_U, _U) + (_I,) * 3 + (_VP, _VP, _VP, _VP))
_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_mesh_render", _ARGTYPES, "mesh")
_TABLE_LIMIT: dict[int, int] = {}  # device index -> the most table bytes a CTA can stage


def table_limit(index: int) -> int:
    """The most table bytes (``PackedMesh.table_bytes``) a CTA of the mesh
    kernel can stage in shared memory on CUDA device ``index``: its opt-in
    shared memory per block less the kernel's static shared memory. Asked
    of the device once per process."""
    limit = _TABLE_LIMIT.get(index)
    if limit is None:
        lib, _ = build.load(KERNEL_SOURCE)
        lib.csgr_mesh_table_limit.argtypes = [ctypes.c_int]
        lib.csgr_mesh_table_limit.restype = ctypes.c_int
        limit = lib.csgr_mesh_table_limit(index)
        if limit < 0:
            raise RuntimeError(f"the mesh kernel's table limit: CUDA error {-limit}")
        _TABLE_LIMIT[index] = limit
    return limit


def launch_args(packed, cam_row, width, height, rows, row_offset, spp, max_bounces, seed,
                sample_offset, lens, sky, nee, shared, out_rgb, out_rays, out_tests,
                out_stats=None) -> tuple:
    """The arguments of ``csgr_mesh_render`` but the stream, after checking
    every tensor it passes (``out_rays``: rows x width + 1 int32;
    ``out_tests``: three int64, which the launch zeroes and fills with its
    path segments' triangle tests, masked visits and coarse skips;
    ``out_stats``: None,
    or the stats block, ``len(build.STATS_WORDS)`` int64, which a stats
    launch zeroes and fills)."""
    dev = packed.device
    f = packed.mesh.num_faces
    lay = packed.layout
    build.check_tensor(packed.faces, "faces", torch.float32, (f, FACE_WORDS), dev)
    build.check_tensor(packed.tables, "tables", torch.float32, (lay.nbytes // 4,), dev)
    build.check_tensor(cam_row, "camera", torch.float32, (CAM_SIZE,), dev)
    build.check_tensor(out_rgb, "out_rgb", torch.float32, (rows, width, 3), dev)
    build.check_tensor(out_rays, "out_rays", torch.int32, (rows * width + 1,), dev)
    build.check_tensor(out_tests, "out_tests", torch.int64, (3,), dev)
    if out_stats is not None:
        build.check_tensor(out_stats, "out_stats", torch.int64, (len(build.STATS_WORDS),), dev)
    grid_args = [0, -1, -1, -1, 0, 0, 0] + [0.0] * 8 + [None] + [0] * 8
    if packed.grid is not None:
        g = packed.grid
        gs = g.static
        p = gs.f32_params()
        masks = packed.masks
        build.check_tensor(masks, "masks", torch.uint32,
                           (g.mask.numel() + g.coarse_mask.numel(),), dev)
        _, mask_ny, mask_nz = gs.mask_dims
        _, coarse_ny, coarse_nz = gs.coarse_dims
        grid_args = ([g.n_globals, lay.glob_at, lay.off_at, lay.ids_at, gs.nx, gs.ny, gs.nz]
                     + [float(v) for v in (*p["lo"], *p["hi"], p["cell"], p["inv_cell"])]
                     + [masks.data_ptr(), masks.numel() * 4, gs.mask_shift, mask_ny, mask_nz,
                        g.mask.numel() * 4, gs.coarse_shift, coarse_ny, coarse_nz])
    lamp_args = [None, 0]
    if nee:
        n_lights = packed.lamps.shape[0]
        build.check_tensor(packed.lamps, "lamps", torch.float32, (n_lights, LAMP_WORDS), dev)
        lamp_args = [packed.lamps.data_ptr(), n_lights]
    return (cam_row.data_ptr(), packed.faces.data_ptr(), packed.tables.data_ptr(),
            lay.nbytes, f, *grid_args, *lamp_args, width, height, rows, row_offset, spp,
            max_bounces, seed & 0xFFFFFFFF, sample_offset & 0xFFFFFFFF, int(lens),
            SKY_MODES.index(sky), int(shared), out_rgb.data_ptr(), out_rays.data_ptr(),
            out_tests.data_ptr(), None if out_stats is None else out_stats.data_ptr())


def _launch(packed, cam_row, width, height, spp, max_bounces, seed, sample_offset, lens, sky,
            nee, rows=None, row_offset=0, force_global=False, counts=None):
    """Launch the kernel. Its tables are staged in shared memory when
    ``packed.table_bytes`` fits the device's limit, else read from global
    memory; ``force_global`` (tests only) reads them from global memory.
    The launch counts its path segments' triangle tests, masked visits and
    coarse skips into three device words, which ``counts`` (a dict) takes
    under ``"tri_tests"``, ``"masked_visits"`` and ``"coarse_skips"``,
    added to what it holds there. A launch in grid mode without NEE from global memory that is
    given ``counts`` runs the stats instantiation where
    ``build.stats_launch()`` says so, and ``counts`` takes its block under
    ``"stats"`` (the first three of ``build.STATS_WORDS``)."""
    global LAUNCHES
    rows = height if rows is None else rows
    dev = packed.device
    _KERNEL.require_cuda(dev)
    out_rgb = torch.empty((rows, width, 3), dtype=torch.float32, device=dev)
    out_rays = torch.empty(rows * width + 1, dtype=torch.int32, device=dev)  # + the work counter
    # the launch zeroes them, then counts into them (int64: the kernel's
    # uint64 words, far from their sign bit)
    tests = torch.empty(3, dtype=torch.int64, device=dev)
    shared = not force_global and packed.table_bytes <= table_limit(dev.index)
    stats = (torch.empty(len(build.STATS_WORDS), dtype=torch.int64, device=dev)
             if counts is not None and packed.grid is not None and not nee and not shared
             and build.stats_launch() else None)
    _KERNEL(dev, *launch_args(packed, cam_row, width, height, rows, row_offset, spp,
                              max_bounces, seed, sample_offset, lens, sky, nee, shared, out_rgb,
                              out_rays, tests, stats))
    LAUNCHES += 1
    LAUNCHES_BY_MODE[packed.mode + ("-nee" if nee else "")] += 1
    LAUNCHES_BY_TABLES["shared" if shared else "global"] += 1
    if counts is not None:
        add_count(counts, "tri_tests", tests[0])
        add_count(counts, "masked_visits", tests[1])
        add_count(counts, "coarse_skips", tests[2])
    if stats is not None:
        add_count(counts, "stats", stats[:3])
    return out_rgb, out_rays[:-1].sum(dtype=torch.int64)  # int32 per pixel, summed in int64


def render_image_mesh_kernel(
    mesh: MeshScene | PackedMesh,
    camera,
    width: int,
    height: int,
    spp: int = 1,
    max_bounces: int = 8,
    seed: int = 0,
    sky: str = "rtiow",
    lens: bool = False,
    sample_offset: int = 0,
    worklist: bool | str = "auto",
    nee: bool = False,
    rows: int | None = None,
    row_offset: int = 0,
    jitter: bool = True,
    counts: dict | None = None,
) -> tuple[Tensor, Tensor]:
    """Drop-in for ``integrator.render_image`` on triangle meshes.

    Returns (image [H, W, 3] f32, rays traced as an int64 scalar tensor).
    ``mesh`` may be a ``PackedMesh`` from ``pack_mesh`` (packed once, e.g.
    by a benchmark); ``worklist`` then must be "auto". Mesh and camera
    tensors on a CUDA device launch the kernel; on the CPU they run the
    plain version; there is no fallback between the two. ``nee`` samples
    the mesh's emissive faces at every Lambertian and glossy hit
    (ValueError if it has none). ``rows``/``row_offset`` and ``jitter`` as
    in ``megakernel.render_image_kernel``: a full-width slab of the frame,
    and pixel centres on the CPU only. ``counts``: a dict to which the
    frame's path-segment triangle tests, masked visits and coarse skips are
    added under ``"tri_tests"``, ``"masked_visits"`` and ``"coarse_skips"``
    as int64 tensors (on the card
    device words the launch fills: nothing waits; a stats launch's block
    under ``"stats"``, see ``_launch``), and on the CPU every key of
    ``render_image_mesh_plain``'s counts. Shadow rays' tests and visits are
    never part of either.
    """
    if sky not in SKY_MODES:
        raise ValueError(f"unknown sky mode {sky!r}")
    if spp < 1 or max_bounces < 0 or width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height} spp={spp} bounces={max_bounces}")
    if isinstance(mesh, PackedMesh):
        if worklist != "auto":
            raise ValueError("worklist is fixed when the mesh is already packed")
        packed = mesh
    else:
        packed = pack_mesh(mesh, worklist)
    if nee and packed.lamps is None:
        raise ValueError(_NO_LAMPS)
    rows = integrator.slab_rows(height, rows, row_offset)
    if packed.device.type == "cpu":
        return render_image_mesh_plain(
            packed, camera, width, height, spp=spp, max_bounces=max_bounces,
            seed=seed, sky=sky, lens=lens, sample_offset=sample_offset, nee=nee,
            counts=counts, rows=rows, row_offset=row_offset, jitter=jitter,
        )
    if not jitter:
        raise NotImplementedError(JITTER_ON_CPU_ONLY)
    return _launch(
        packed, pack_camera(camera).contiguous(), width, height, spp, max_bounces, int(seed),
        int(sample_offset), lens, sky, nee, rows, int(row_offset), counts=counts,
    )
