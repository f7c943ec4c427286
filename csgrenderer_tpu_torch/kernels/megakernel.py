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

``LAUNCHES`` counts kernel launches (``LAUNCHES_BY_MODE`` per mode); only
the launch site adds to them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch import Tensor

from ..math import vec
from ..render import integrator
from ..render.integrator import SKY_MODES, SphereScene, SurfaceHit
from . import build
from .worklist import GridPack, grid_nearest_hit, pack_grid

GRID_MIN_SPHERES = 256  # the JAX package's measured brute/grid crossover (TPU)
SPHERE_WORDS = 12  # floats per sphere record in the kernel's table
CAM_SIZE = 24
KERNEL_SOURCE = "sphere_megakernel"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"grid": 0, "brute": 0}


@dataclass(frozen=True)
class PackedScene:
    """A sphere scene prepared for the kernel (host-side, once per scene).

    ``scene`` is reordered globals-first in grid mode. ``spheres`` holds,
    per sphere, three float4: (cx, cy, cz, r^2), (c.c, r signed, kind,
    param), (albedo r, g, b, 0). All values are exact f32.
    """

    scene: SphereScene
    spheres: Tensor  # [S, 12] f32
    grid: GridPack | None

    @property
    def mode(self) -> str:
        return "brute" if self.grid is None else "grid"

    @property
    def n_brute(self) -> int:
        return self.scene.num_spheres if self.grid is None else self.grid.n_globals

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def to(self, device) -> "PackedScene":
        grid = None if self.grid is None else self.grid.to(device)
        return PackedScene(self.scene.to(device), self.spheres.to(device), grid)


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


def pack_scene(scene: SphereScene, worklist: bool | str = "auto") -> PackedScene:
    """Choose the mode and build the kernel's tables on the scene's device.

    ``worklist``: "auto" takes grid mode for scenes of at least 256 spheres
    that ``pack_grid`` can bin; True forces grid mode (and raises if the
    scene is not griddable); False forces brute mode.
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
    return PackedScene(scene, _sphere_table(scene), grid)


def pack_camera(camera) -> Tensor:
    """The camera as the kernel reads it: [24] f32 (19 values + padding)."""
    vals = torch.cat([
        camera.origin, camera.lower_left, camera.horizontal, camera.vertical,
        camera.u, camera.v, camera.lens_radius.reshape(1),
    ]).to(torch.float32)
    return torch.cat([vals, vals.new_zeros(CAM_SIZE - vals.numel())])


def _grid_hit_fn(packed: PackedScene):
    def hit_fn(o: Tensor, d: Tensor) -> SurfaceHit:
        batch = o.shape[:-1]
        flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, idx, hit = grid_nearest_hit(packed.grid, packed.scene, flat_o, flat_d)
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
) -> tuple[Tensor, Tensor]:
    """The plain torch version of the kernel, on any device."""
    hit_fn = packed.scene.nearest_hit if packed.grid is None else _grid_hit_fn(packed)
    return integrator.render_image(
        hit_fn, camera, width, height, spp=spp, max_bounces=max_bounces,
        seed=seed, sky=sky, lens=lens, sample_offset=sample_offset,
    )


@functools.cache
def _kernel_fn():
    lib, _ = build.load(KERNEL_SOURCE)
    fn = lib.csgr_sphere_render
    vp, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    fn.argtypes = [vp, vp, i, vp, i, i, i, i] + [f] * 8 + [i] * 4 + [u, u, i, i, vp, vp, vp]
    fn.restype = ctypes.c_int
    lib.csgr_error_string.argtypes = [ctypes.c_int]
    lib.csgr_error_string.restype = ctypes.c_char_p
    return fn, lib.csgr_error_string


def _check(t: Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(packed, cam_row, width, height, spp, max_bounces, seed, sample_offset, lens, sky):
    global LAUNCHES
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the sphere kernel needs CUDA tensors, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("the sphere kernel needs CUDA, and CUDA is not available")
    s = packed.scene.num_spheres
    _check(packed.spheres, "spheres", torch.float32, (s, SPHERE_WORDS), dev)
    _check(cam_row, "camera", torch.float32, (CAM_SIZE,), dev)
    grid_args = [None, 0, 0, 0, 0] + [0.0] * 8
    if packed.grid is not None:
        gs = packed.grid.static
        _check(packed.grid.cell_ids, "cell_ids", torch.int32, (gs.cx * gs.cz, gs.m), dev)
        f = gs.f32_params()
        grid_args = [packed.grid.cell_ids.data_ptr(), gs.cx, gs.cz, gs.m, gs.max_steps] + [
            float(f[k]) for k in ("x0", "z0", "x1", "z1", "y_lo", "y_hi", "cell", "inv_cell")
        ]

    fn, err_str = _kernel_fn()
    out_rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    out_rays = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            cam_row.data_ptr(), packed.spheres.data_ptr(), packed.n_brute, *grid_args,
            width, height, spp, max_bounces, seed & 0xFFFFFFFF, sample_offset & 0xFFFFFFFF,
            int(lens), SKY_MODES.index(sky), out_rgb.data_ptr(), out_rays.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sphere kernel launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
    LAUNCHES_BY_MODE[packed.mode] += 1
    # int64 sum: one call can pass 2**31 segments (a 1080p/64-spp frame
    # traces ~3.4e8; 4K at a few hundred spp overflows int32)
    return out_rgb, out_rays.sum(dtype=torch.int64)


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
) -> tuple[Tensor, Tensor]:
    """Drop-in for ``integrator.render_image`` on sphere scenes.

    Returns (image [H, W, 3] f32, rays traced as an int64 scalar tensor).
    ``scene`` may be a ``PackedScene`` from ``pack_scene`` (packed once,
    e.g. by a benchmark); ``worklist`` then must be "auto". Scene and
    camera tensors on a CUDA device launch the kernel; on the CPU they run
    the plain version; there is no fallback between the two.
    """
    if nee:
        raise NotImplementedError("next-event estimation is not ported yet (ROADMAP B3)")
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
    if packed.device.type == "cpu":
        return render_image_plain(
            packed, camera, width, height, spp=spp, max_bounces=max_bounces,
            seed=seed, sky=sky, lens=lens, sample_offset=sample_offset,
        )
    return _launch(
        packed, pack_camera(camera).contiguous(), width, height, spp, max_bounces,
        int(seed), int(sample_offset), lens, sky,
    )

