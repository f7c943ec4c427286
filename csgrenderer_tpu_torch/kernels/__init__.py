"""Kernels: the sphere and voxel grid packers, the CUDA sphere megakernel,
the CUDA CSG tape kernel, the CUDA triangle-mesh kernel, the shard canary,
the a-trous filter's pass, and their build.

Launch counts live on the modules (``megakernel.LAUNCHES``,
``tape_kernel.LAUNCHES``, ``trimesh_kernel.LAUNCHES``,
``shard_canary.LAUNCHES``, ``atrous.LAUNCHES``), each module's counters
registered in ``build.LAUNCH_COUNTERS``: read them there, since a name
imported from them would be a copy.
"""

from . import atrous, megakernel, shard_canary, tape_kernel, tri_worklist, trimesh_kernel, worklist
from .megakernel import PackedScene, pack_camera, pack_scene, render_image_kernel, render_image_plain
from .tape_kernel import PackedTape, pack_program, render_image_tape_kernel, render_image_tape_plain
from .tri_worklist import TriGridPack, pack_tri_grid, tri_grid_nearest_hit
from .trimesh_kernel import PackedMesh, pack_mesh, render_image_mesh_kernel, render_image_mesh_plain
from .worklist import GridPack, GridStatic, grid_nearest_hit, pack_grid

__all__ = [
    "atrous",
    "megakernel",
    "shard_canary",
    "tape_kernel",
    "tri_worklist",
    "trimesh_kernel",
    "worklist",
    "PackedScene",
    "pack_camera",
    "pack_scene",
    "render_image_kernel",
    "render_image_plain",
    "PackedTape",
    "pack_program",
    "render_image_tape_kernel",
    "render_image_tape_plain",
    "PackedMesh",
    "pack_mesh",
    "render_image_mesh_kernel",
    "render_image_mesh_plain",
    "TriGridPack",
    "pack_tri_grid",
    "tri_grid_nearest_hit",
    "GridPack",
    "GridStatic",
    "grid_nearest_hit",
    "pack_grid",
]
