"""The sphere megakernel: packing, the CUDA launch, and its plain version.

Twin of ``csgrenderer_tpu/kernels/megakernel.py`` (``pack_scene``,
``pack_camera``, ``render_image_pallas``). ``render_image_kernel`` renders
a sphere scene in one of two modes, chosen as the JAX package chooses:
grid mode (globals brute-forced, then a per-ray xz-grid DDA over cell
lists) for scenes of at least 256 spheres that ``pack_grid`` can bin,
brute mode (every sphere against every ray) otherwise.

Where the tensors lie decides what runs:

- on a CUDA device, the hand-written kernel ``csrc/sphere_megakernel.cu``
  (built for sm_90a at first use) is launched, or an error is raised;
- on the CPU, the plain torch version ``render_image_plain`` runs:
  ``render/integrator.render_image`` with the brute hit function, or with
  ``worklist.grid_nearest_hit`` in grid mode.

``nee=True`` adds next-event estimation toward the scene's emissive
spheres (``render/lights.py``): the kernel's NEE variant, or the plain
version with ``lights=``. Both count the shadow rays they trace, by the
same rule, and keep them out of the segment count ``rays``: the kernel
into a device word of its own, which ``counts`` hands back as a tensor
without waiting for the device (see ``render_image_kernel``).

A launch in grid mode from staged tables that is handed ``counts`` may
run the kernel's stats instantiation (``build.stats_launch``: one such
launch in ``build.STATS_EVERY`` while the program's spans record): the
same image, segments and shadow rays, and a block of work counts
(``build.STATS_WORDS``: the segment loop's and the walk loop's warp turns,
the walk's lane turns and, with NEE, the shadow rays' part of them) that
``counts`` takes under ``"stats"``. The plain version's grid walk counts
its cell visits (``worklist.grid_nearest_hit``), the lane turns of the
kernel's walk.

``render_aovs_kernel`` is the kernel's G-buffer mode: the AOV cast of
``render/aov.py::render_aovs`` (one centred primary ray a pixel, the
denoiser's edge stops) over the same packed tables, CUDA tensors only; its
plain version ``render_aovs_plain`` is ``render_aovs`` through the packed
scene's plain hit function. ``LAUNCHES`` counts kernel launches
(``LAUNCHES_BY_MODE`` per mode: grid, brute, grid-nee, brute-nee, gbuffer;
``LAUNCHES_BY_TABLES`` by where the launch read its scene tables: staged in
shared memory, or global memory when ``PackedScene.table_bytes`` exceeds
``table_limit``); only the launch site adds to them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
from torch import Tensor

from ..math import vec
from ..render import integrator
from ..render.aov import AOVs, render_aovs
from ..render.integrator import SKY_MODES, SphereScene, SurfaceHit
from ..render.lights import SphereLights, extract_lights
from . import build
from .worklist import GridPack, add_count, grid_nearest_hit, pack_grid

GRID_MIN_SPHERES = 256  # the JAX package's measured brute/grid crossover (TPU)
SPHERE_WORDS = 12  # floats per sphere record in the kernel's table
GEOMETRY_WORDS = 8  # floats per sphere a test reads: the record's first two float4
LAMP_WORDS = 8  # floats per lamp record: centre, |r|, emitted rgb, sphere id
CAM_SIZE = 24
KERNEL_SOURCE = "sphere_megakernel"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"grid": 0, "brute": 0, "grid-nee": 0, "brute-nee": 0, "gbuffer": 0}
# where a launch read the geometry and cell tables: staged in each CTA's
# shared memory, or from global memory (tables over the device's limit)
LAUNCHES_BY_TABLES = {"shared": 0, "global": 0}
build.count_launches(__name__, "LAUNCHES", "LAUNCHES_BY_MODE", "LAUNCHES_BY_TABLES")
_NO_LAMPS = "nee=True but the scene has no emissive spheres"
JITTER_ON_CPU_ONLY = ("a CUDA kernel always jitters: jitter=False (pixel centres) renders only on "
                      "the CPU, through the plain versions")


@dataclass(frozen=True)
class PackedScene:
    """A sphere scene prepared for the kernel (host-side, once per scene).

    ``scene`` is reordered globals-first in grid mode. ``spheres`` holds,
    per sphere, three float4: (cx, cy, cz, r^2), (c.c, r signed, kind,
    param), (albedo r, g, b, 0). All values are exact f32. ``geometry``
    is the first two float4 of each record, contiguous: what a sphere
    test reads, which the kernel stages in shared memory. ``lamps`` is
    the NEE lamp table, one row (cx, cy, cz, |r|, emitted r, g, b, sphere
    id) per emissive sphere of the reordered scene, so every id is in the
    kernel's id space; None when the scene has no emissive sphere.
    """

    scene: SphereScene
    spheres: Tensor  # [S, 12] f32
    geometry: Tensor  # [S, 8] f32, spheres[:, :8]
    grid: GridPack | None
    lamps: Tensor | None  # [n_lights, 8] f32

    @property
    def mode(self) -> str:
        return "brute" if self.grid is None else "grid"

    @property
    def n_brute(self) -> int:
        return self.scene.num_spheres if self.grid is None else self.grid.n_globals

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    @property
    def table_bytes(self) -> int:
        """The bytes a CTA stages in shared memory: S x 32 of geometry and,
        in grid mode, cx x cz x m x 4 of cell lists (both multiples of 16)."""
        cells = 0 if self.grid is None else self.grid.cell_ids.numel() * 4
        return self.geometry.numel() * 4 + cells

    @property
    def lights(self) -> SphereLights | None:
        """The lamp table as the plain version's ``SphereLights``."""
        if self.lamps is None:
            return None
        return SphereLights(self.lamps[:, 0:3], self.lamps[:, 3], self.lamps[:, 4:7])

    def to(self, device) -> "PackedScene":
        grid = None if self.grid is None else self.grid.to(device)
        lamps = None if self.lamps is None else self.lamps.to(device)
        return PackedScene(self.scene.to(device), self.spheres.to(device),
                           self.geometry.to(device), grid, lamps)


def _sphere_table(scene: SphereScene) -> Tensor:
    tab = torch.zeros((scene.num_spheres, SPHERE_WORDS), dtype=torch.float32, device=scene.device)
    tab[:, 0:3] = scene.centers
    tab[:, 3] = scene.radii * scene.radii
    tab[:, 4] = vec.dot(scene.centers, scene.centers)  # as spheres_nearest_hit forms it
    tab[:, 5] = scene.radii  # signed: a NEGATIVE radius flips the normal (hollow bubble)
    tab[:, 6] = scene.mat_kind.to(torch.float32)
    tab[:, 7] = scene.mat_param
    tab[:, 8:11] = scene.albedo
    return tab


def _lamp_table(scene: SphereScene) -> Tensor | None:
    """The JAX packer's [n_lights, 8] lamp rows (``megakernel.py:899-906``)."""
    lights, ids = extract_lights(scene, return_ids=True)
    if lights is None:
        return None
    tab = torch.zeros((lights.num_lights, LAMP_WORDS), dtype=torch.float32, device=scene.device)
    tab[:, 0:3] = lights.centers
    tab[:, 3] = lights.radii
    tab[:, 4:7] = lights.emit
    tab[:, 7] = torch.from_numpy(ids.astype("float32")).to(scene.device)
    return tab


def pack_scene(scene: SphereScene, worklist: bool | str = "auto") -> PackedScene:
    """Choose the mode and build the kernel's tables on the scene's device.

    ``worklist``: "auto" takes grid mode for scenes of at least 256 spheres
    that ``pack_grid`` can bin; True forces grid mode (and raises if the
    scene is not griddable); False forces brute mode. The lamp table is
    taken after the grid's globals-first reorder.
    """
    if worklist not in ("auto", True, False):
        raise ValueError(f"worklist must be 'auto', True or False, got {worklist!r}")
    if worklist == "auto" and scene.num_spheres < GRID_MIN_SPHERES:
        worklist = False
    grid = None
    if worklist in (True, "auto"):
        packed = pack_grid(scene)
        if packed is not None:
            grid, scene = packed
        elif worklist is True:
            raise ValueError("worklist=True but the scene is not griddable")
    spheres = _sphere_table(scene)
    return PackedScene(scene, spheres, spheres[:, :GEOMETRY_WORDS].contiguous(), grid,
                       _lamp_table(scene))


def pack_camera(camera) -> Tensor:
    """The camera as the kernel reads it: [24] f32 (19 values + padding)."""
    vals = torch.cat([
        camera.origin, camera.lower_left, camera.horizontal, camera.vertical,
        camera.u, camera.v, camera.lens_radius.reshape(1),
    ]).to(torch.float32)
    return torch.cat([vals, vals.new_zeros(CAM_SIZE - vals.numel())])


def camera_row(camera) -> Tensor:
    """The row a launch reads: a ``Camera`` packed now, or a row that
    ``pack_camera`` made before (a frame graph's, rewritten in place for
    each new view) as it is."""
    return camera if isinstance(camera, Tensor) else pack_camera(camera).contiguous()


def plain_hit_fn(packed: PackedScene, counts: dict | None = None):
    """The packed scene's plain hit function, the one its kernel mode
    repeats: brute force over every sphere, or in grid mode the globals
    and ``worklist.grid_nearest_hit``'s walk (whose work is added to
    ``counts``)."""
    if packed.grid is None:
        return packed.scene.nearest_hit

    def hit_fn(o: Tensor, d: Tensor) -> SurfaceHit:
        batch = o.shape[:-1]
        flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, idx, hit = grid_nearest_hit(packed.grid, packed.scene, flat_o, flat_d, counts=counts)
        h = packed.scene.surface_hit(flat_o, flat_d, t, idx, hit)
        return SurfaceHit(*(x.reshape(batch + x.shape[1:]) for x in h))

    return hit_fn


def render_image_plain(
    packed: PackedScene,
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
    (``worklist.grid_nearest_hit``, shadow rays included); ``rows``,
    ``row_offset``, ``jitter`` and ``sample_batch`` as in
    ``integrator.render_image``."""
    if nee and packed.lamps is None:
        raise ValueError(_NO_LAMPS)
    return integrator.render_image(
        plain_hit_fn(packed, counts), camera, width, height, spp=spp, max_bounces=max_bounces,
        seed=seed, sky=sky, jitter=jitter, lens=lens, sample_offset=sample_offset,
        lights=packed.lights if nee else None, counts=counts, rows=rows, row_offset=row_offset,
        sample_batch=sample_batch,
    )


_VP, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_SCENE_ARGTYPES = (_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _I) + (_F,) * 8
_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_sphere_render", _SCENE_ARGTYPES + (_VP, _I)
                       + (_I,) * 6 + (_U, _U, _VP, _I, _I, _I, _VP, _VP, _VP, _VP), "sphere")
_GBUFFER = build.Kernel(KERNEL_SOURCE, "csgr_sphere_gbuffer", _SCENE_ARGTYPES + (_I,) * 4
                        + (_VP,) * 5, "sphere G-buffer")
_TABLE_LIMIT: dict[int, int] = {}  # device index -> the most table bytes a CTA can stage


def table_limit(index: int) -> int:
    """The most table bytes (``PackedScene.table_bytes``) a CTA of the
    sphere kernel can stage in shared memory on CUDA device ``index``: its
    opt-in shared memory per block less the kernel's static shared memory.
    Asked of the device once per process."""
    limit = _TABLE_LIMIT.get(index)
    if limit is None:
        lib, _ = build.load(KERNEL_SOURCE)
        lib.csgr_sphere_table_limit.argtypes = [ctypes.c_int]
        lib.csgr_sphere_table_limit.restype = ctypes.c_int
        limit = lib.csgr_sphere_table_limit(index)
        if limit < 0:
            raise RuntimeError(f"the sphere kernel's table limit: CUDA error {-limit}")
        _TABLE_LIMIT[index] = limit
    return limit


def _scene_args(packed: PackedScene, cam_row: Tensor, dev) -> list:
    """The checked scene arguments both C entry points begin with: the
    camera, the sphere and geometry tables, and the grid's cell lists and
    parameters (null and zeros in brute mode)."""
    s = packed.scene.num_spheres
    build.check_tensor(packed.spheres, "spheres", torch.float32, (s, SPHERE_WORDS), dev)
    build.check_tensor(packed.geometry, "geometry", torch.float32, (s, GEOMETRY_WORDS), dev)
    build.check_tensor(cam_row, "camera", torch.float32, (CAM_SIZE,), dev)
    grid_args = [None, 0, 0, 0, 0] + [0.0] * 8
    if packed.grid is not None:
        gs = packed.grid.static
        build.check_tensor(packed.grid.cell_ids, "cell_ids", torch.int32, (gs.cx * gs.cz, gs.m), dev)
        f = gs.f32_params()
        grid_args = [packed.grid.cell_ids.data_ptr(), gs.cx, gs.cz, gs.m, gs.max_steps] + [
            float(f[k]) for k in ("x0", "z0", "x1", "z1", "y_lo", "y_hi", "cell", "inv_cell")
        ]
    return [cam_row.data_ptr(), packed.spheres.data_ptr(), packed.geometry.data_ptr(), s,
            packed.n_brute, *grid_args]


def _launch(packed, cam_row, width, height, spp, max_bounces, seed, sample_offset, lens, sky,
            nee, rows=None, row_offset=0, force_global=False, offset_buffer=None, counts=None):
    """Launch the kernel. Its tables are staged in shared memory when
    ``packed.table_bytes`` fits the device's limit, else read from global
    memory; ``force_global`` (tests only) reads them from global memory.
    ``offset_buffer``, a one-element int32 CUDA tensor, is read by the
    kernel in place of ``sample_offset`` (its bits as uint32) when the
    launch runs: a launch captured in a CUDA graph takes each replay's
    offset from it. With ``nee`` the launch counts its shadow rays into a
    device word, which ``counts`` (a dict) takes under ``"shadow_rays"``,
    added to what it holds there. A launch in grid mode from staged tables
    that is given ``counts`` runs the stats instantiation where
    ``build.stats_launch()`` says so, and ``counts`` takes its block under
    ``"stats"`` (the first three of ``build.STATS_WORDS``, all four with
    NEE)."""
    global LAUNCHES
    rows = height if rows is None else rows
    dev = packed.device
    _KERNEL.require_cuda(dev)
    scene_args = _scene_args(packed, cam_row, dev)
    lamp_args = [None, 0]
    if nee:
        n_lights = packed.lamps.shape[0]
        build.check_tensor(packed.lamps, "lamps", torch.float32, (n_lights, LAMP_WORDS), dev)
        lamp_args = [packed.lamps.data_ptr(), n_lights]
    offset_at = None
    if offset_buffer is not None:
        build.check_tensor(offset_buffer, "offset_buffer", torch.int32, (1,), dev)
        offset_at = offset_buffer.data_ptr()

    out_rgb = torch.empty((rows, width, 3), dtype=torch.float32, device=dev)
    out_rays = torch.empty(rows * width + 1, dtype=torch.int32, device=dev)  # + the work counter
    # the launch zeroes it, then counts its shadow rays into it (int64: the
    # kernel's uint64 word, far from its sign bit)
    shadow = torch.empty((), dtype=torch.int64, device=dev) if nee else None
    shared = not force_global and packed.table_bytes <= table_limit(dev.index)
    stats = (torch.empty(len(build.STATS_WORDS), dtype=torch.int64, device=dev)
             if counts is not None and shared and packed.grid is not None
             and build.stats_launch() else None)
    _KERNEL(
        dev, *scene_args, *lamp_args, width, height, rows, row_offset, spp,
        max_bounces, seed & 0xFFFFFFFF, sample_offset & 0xFFFFFFFF, offset_at, int(lens),
        SKY_MODES.index(sky), int(shared), out_rgb.data_ptr(), out_rays.data_ptr(),
        None if shadow is None else shadow.data_ptr(), None if stats is None else stats.data_ptr(),
    )
    LAUNCHES += 1
    LAUNCHES_BY_MODE[packed.mode + ("-nee" if nee else "")] += 1
    LAUNCHES_BY_TABLES["shared" if shared else "global"] += 1
    if shadow is not None and counts is not None:
        counts["shadow_rays"] = shadow if "shadow_rays" not in counts else (
            counts["shadow_rays"] + shadow)
    if stats is not None:
        add_count(counts, "stats", stats if nee else stats[:3])
    # int64 sum: one call can pass 2**31 segments (a 1080p/64-spp frame
    # traces ~3.4e8; 4K at a few hundred spp overflows int32)
    return out_rgb, out_rays[:-1].sum(dtype=torch.int64)


def render_image_kernel(
    scene: SphereScene | PackedScene,
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
    offset_buffer: Tensor | None = None,
    counts: dict | None = None,
) -> tuple[Tensor, Tensor]:
    """Drop-in for ``integrator.render_image`` on sphere scenes.

    Returns (image [H, W, 3] f32, rays traced as an int64 scalar tensor).
    ``rows``/``row_offset`` render the full-width slab of rows
    [row_offset, row_offset + rows) of the ``width x height`` frame
    ([rows, W, 3] and that slab's rays; camera and RNG stay functions of
    global pixel coordinates, so the slab is the frame's rows bit for
    bit). ``jitter=False`` (pixel centres) runs on the CPU only: the
    kernel always jitters, as the JAX package's does.
    ``scene`` may be a ``PackedScene`` from ``pack_scene`` (packed once,
    e.g. by a benchmark); ``worklist`` then must be "auto". Scene and
    camera tensors on a CUDA device launch the kernel; on the CPU they run
    the plain version; there is no fallback between the two. ``nee``
    samples the scene's emissive spheres at every Lambertian and glossy
    hit (ValueError if it has none). On the card, ``camera`` may also be
    a packed row (``camera_row``), and ``offset_buffer`` (see ``_launch``)
    holds the sample offset the kernel reads when it runs. ``counts``: a
    dict to which the frame's NEE work is added as int64 tensors, by the
    plain version's rule: on the card the shadow rays traced
    (``"shadow_rays"``, in a device word the launch fills: nothing waits)
    and, on a stats launch (``_launch``), the stats block (``"stats"``), on
    the CPU every key of ``integrator.trace_paths`` and the grid walk's
    (``render_image_plain``). Shadow rays are never part of ``rays``.
    """
    if sky not in SKY_MODES:
        raise ValueError(f"unknown sky mode {sky!r}")
    if spp < 1 or max_bounces < 0 or width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height} spp={spp} bounces={max_bounces}")
    if isinstance(scene, PackedScene):
        if worklist != "auto":
            raise ValueError("worklist is fixed when the scene is already packed")
        packed = scene
    else:
        packed = pack_scene(scene, worklist)
    if nee and packed.lamps is None:
        raise ValueError(_NO_LAMPS)
    rows = integrator.slab_rows(height, rows, row_offset)
    if packed.device.type == "cpu":
        if offset_buffer is not None or isinstance(camera, Tensor):
            raise ValueError("a camera row and offset_buffer are read by the CUDA kernel only")
        return render_image_plain(
            packed, camera, width, height, spp=spp, max_bounces=max_bounces,
            seed=seed, sky=sky, lens=lens, sample_offset=sample_offset, nee=nee,
            counts=counts, rows=rows, row_offset=row_offset, jitter=jitter,
        )
    if not jitter:
        raise NotImplementedError(JITTER_ON_CPU_ONLY)
    return _launch(
        packed, camera_row(camera), width, height, spp, max_bounces, int(seed),
        int(sample_offset), lens, sky, nee, rows, int(row_offset), offset_buffer=offset_buffer,
        counts=counts,
    )


def render_aovs_plain(packed: PackedScene, camera, width: int, height: int, sky: str = "rtiow",
                      counts: dict | None = None) -> AOVs:
    """The G-buffer mode's plain version, on any device: ``render_aovs``
    through ``plain_hit_fn(packed, counts)``."""
    return render_aovs(plain_hit_fn(packed, counts), camera, width, height, sky=sky)


def render_aovs_kernel(packed: PackedScene, camera, width: int, height: int,
                       sky: str = "rtiow", force_global: bool = False) -> AOVs:
    """The AOVs of ``render/aov.py::render_aovs`` for a packed sphere scene
    through the kernel's G-buffer mode: one launch, one centred primary ray
    a pixel, over the tables the beauty frame reads (staged in shared
    memory when they fit, as ``_launch`` decides; ``force_global``, tests
    only, reads them from global memory). ``packed`` and ``camera`` (or its
    packed row, ``camera_row``) must lie on a CUDA device (ValueError
    otherwise): the CPU's cast is
    ``render_aovs_plain`` or ``render_aovs``, which the caller chooses."""
    global LAUNCHES
    if sky not in SKY_MODES:
        raise ValueError(f"unknown sky mode {sky!r}")
    if width < 1 or height < 1:
        raise ValueError(f"bad frame {width}x{height}")
    dev = packed.device
    _GBUFFER.require_cuda(dev)
    # held to the launch: a camera row freed here could be handed to the
    # work counter below, which the launch zeroes before the kernel reads it
    cam_row = camera_row(camera)
    scene_args = _scene_args(packed, cam_row, dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    normal = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    albedo = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    hit = torch.empty((height, width), dtype=torch.bool, device=dev)  # written as 0 or 1
    work = torch.empty(1, dtype=torch.int32, device=dev)  # the launch's work counter
    shared = not force_global and packed.table_bytes <= table_limit(dev.index)
    _GBUFFER(dev, *scene_args, width, height, SKY_MODES.index(sky), int(shared),
             depth.data_ptr(), normal.data_ptr(), albedo.data_ptr(), hit.data_ptr(),
             work.data_ptr())
    LAUNCHES += 1
    LAUNCHES_BY_MODE["gbuffer"] += 1
    LAUNCHES_BY_TABLES["shared" if shared else "global"] += 1
    return AOVs(depth, normal, albedo, hit)
