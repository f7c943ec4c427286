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
plain version with ``lights=``. ``LAUNCHES`` counts kernel launches
(``LAUNCHES_BY_MODE`` per mode: brute, grid, brute-nee, grid-nee); only
the launch site adds to them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch import Tensor

from ..render import integrator
from ..render.integrator import SKY_MODES, SurfaceHit
from ..render.lights import TriLights, extract_mesh_lights
from ..render.trimesh import MeshScene
from . import build
from .megakernel import CAM_SIZE, pack_camera
from .tri_worklist import TriGridPack, pack_tri_grid, tri_grid_nearest_hit

FACE_WORDS = 20  # floats per face record: v0, e1, e2, unit normal, kind, param, albedo, pad
LAMP_WORDS = 16  # floats per lamp record: v0, e1, e2, emitted rgb, unit normal, area
KERNEL_SOURCE = "trimesh_kernel"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"brute": 0, "grid": 0, "brute-nee": 0, "grid-nee": 0}
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
    """

    mesh: MeshScene
    faces: Tensor  # [F, 20] f32
    grid: TriGridPack | None
    lamps: Tensor | None  # [n_lights, 16] f32

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
    def lights(self) -> TriLights | None:
        """The lamp table as the plain version's ``TriLights``."""
        if self.lamps is None:
            return None
        t = self.lamps
        return TriLights(t[:, 0:3], t[:, 3:6], t[:, 6:9], t[:, 9:12], t[:, 12:15], t[:, 15])

    def to(self, device) -> "PackedMesh":
        grid = None if self.grid is None else self.grid.to(device)
        lamps = None if self.lamps is None else self.lamps.to(device)
        return PackedMesh(self.mesh.to(device), self.faces.to(device), grid, lamps)


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


def pack_mesh(mesh: MeshScene, worklist: bool | str = "auto") -> PackedMesh:
    """Choose the mode and build the kernel's tables on the mesh's device.

    ``worklist``: "auto" takes grid mode when ``pack_tri_grid`` grids the
    mesh (192 faces or more); True forces grid mode (and raises if the
    mesh is not griddable); False forces brute mode. The JAX package's
    "stream" and "tiered" are TPU gather modes and raise.
    """
    if worklist in ("stream", "tiered"):
        raise ValueError(f"worklist={worklist!r} is a TPU gather mode with no counterpart here: "
                         "grid mode keeps the voxel lists in device memory at any mesh size, "
                         "so use 'auto' or True")
    if worklist not in ("auto", True, False):
        raise ValueError(f"worklist must be 'auto', True or False, got {worklist!r}")
    grid = None
    if worklist in (True, "auto"):
        grid = pack_tri_grid(mesh)
        if grid is None and worklist is True:
            raise ValueError("worklist=True but the mesh is not griddable "
                             "(under 192 faces to grid)")
    return PackedMesh(mesh, _face_table(mesh), grid, _lamp_table(mesh))


def _grid_hit_fn(packed: PackedMesh, counts: dict | None):
    def hit_fn(o: Tensor, d: Tensor) -> SurfaceHit:
        batch = o.shape[:-1]
        flat_o, flat_d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, idx, _ = tri_grid_nearest_hit(packed.grid, packed.mesh, flat_o, flat_d, counts=counts)
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
) -> tuple[Tensor, Tensor]:
    """The plain torch version of the kernel, on any device. With ``nee``
    it renders with the packed lamp table as ``lights=``; ``counts`` as in
    ``integrator.trace_paths``, plus, in grid mode, the walk's work
    (``tri_worklist.tri_grid_nearest_hit``, shadow rays included)."""
    if nee and packed.lamps is None:
        raise ValueError(_NO_LAMPS)
    if packed.grid is None:
        hit_fn = functools.partial(packed.mesh.nearest_hit, normals=packed.normals)
    else:
        hit_fn = _grid_hit_fn(packed, counts)
    return integrator.render_image(
        hit_fn, camera, width, height, spp=spp, max_bounces=max_bounces,
        seed=seed, sky=sky, lens=lens, sample_offset=sample_offset,
        lights=packed.lights if nee else None, counts=counts,
    )


_VP, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_ARGTYPES = ((_VP, _VP, _I, _VP, _I, _VP, _VP, _I, _I, _I) + (_F,) * 8 + (_VP, _I) + (_I,) * 4
             + (_U, _U, _I, _I, _VP, _VP, _VP))


def _launch(packed, cam_row, width, height, spp, max_bounces, seed, sample_offset, lens, sky,
            nee):
    global LAUNCHES
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the mesh kernel needs CUDA tensors, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("the mesh kernel needs CUDA, and CUDA is not available")
    f = packed.mesh.num_faces
    build.check_tensor(packed.faces, "faces", torch.float32, (f, FACE_WORDS), dev)
    build.check_tensor(cam_row, "camera", torch.float32, (CAM_SIZE,), dev)
    grid_args = [None, 0, None, None, 0, 0, 0] + [0.0] * 8
    if packed.grid is not None:
        g = packed.grid
        gs = g.static
        build.check_tensor(g.globals_idx, "globals_idx", torch.int32, (g.n_globals,), dev)
        build.check_tensor(g.offsets, "offsets", torch.int32, (gs.n_voxels + 1,), dev)
        build.check_tensor(g.face_ids, "face_ids", torch.int32, (g.face_ids.numel(),), dev)
        p = gs.f32_params()
        grid_args = [g.globals_idx.data_ptr(), g.n_globals, g.offsets.data_ptr(),
                     g.face_ids.data_ptr(), gs.nx, gs.ny, gs.nz] + [
            float(v) for v in (*p["lo"], *p["hi"], p["cell"], p["inv_cell"])]
    lamp_args = [None, 0]
    if nee:
        n_lights = packed.lamps.shape[0]
        build.check_tensor(packed.lamps, "lamps", torch.float32, (n_lights, LAMP_WORDS), dev)
        lamp_args = [packed.lamps.data_ptr(), n_lights]

    fn, err_str = build.bind(KERNEL_SOURCE, "csgr_mesh_render", _ARGTYPES)
    out_rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    out_rays = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            cam_row.data_ptr(), packed.faces.data_ptr(), f, *grid_args, *lamp_args,
            width, height, spp, max_bounces, seed & 0xFFFFFFFF, sample_offset & 0xFFFFFFFF,
            int(lens), SKY_MODES.index(sky), out_rgb.data_ptr(), out_rays.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"mesh kernel launch failed: {err_str(rc).decode()} ({rc})")
    LAUNCHES += 1
    LAUNCHES_BY_MODE[packed.mode + ("-nee" if nee else "")] += 1
    return out_rgb, out_rays.sum(dtype=torch.int64)  # int32 per pixel, summed in int64


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
) -> tuple[Tensor, Tensor]:
    """Drop-in for ``integrator.render_image`` on triangle meshes.

    Returns (image [H, W, 3] f32, rays traced as an int64 scalar tensor).
    ``mesh`` may be a ``PackedMesh`` from ``pack_mesh`` (packed once, e.g.
    by a benchmark); ``worklist`` then must be "auto". Mesh and camera
    tensors on a CUDA device launch the kernel; on the CPU they run the
    plain version; there is no fallback between the two. ``nee`` samples
    the mesh's emissive faces at every Lambertian and glossy hit
    (ValueError if it has none).
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
    if packed.device.type == "cpu":
        return render_image_mesh_plain(
            packed, camera, width, height, spp=spp, max_bounces=max_bounces,
            seed=seed, sky=sky, lens=lens, sample_offset=sample_offset, nee=nee,
        )
    return _launch(
        packed, pack_camera(camera).contiguous(), width, height, spp, max_bounces,
        int(seed), int(sample_offset), lens, sky, nee,
    )
