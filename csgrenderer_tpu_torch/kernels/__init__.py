"""Kernels: the grid packer, the CUDA sphere megakernel, the CUDA CSG tape
kernel, and their build.

Launch counts live on the modules (``megakernel.LAUNCHES``,
``tape_kernel.LAUNCHES``): read them there, since a name imported from
them would be a copy.
"""

from . import megakernel, tape_kernel, worklist
from .megakernel import PackedScene, pack_camera, pack_scene, render_image_kernel, render_image_plain
from .tape_kernel import PackedTape, pack_program, render_image_tape_kernel, render_image_tape_plain
from .worklist import GridPack, GridStatic, grid_nearest_hit, pack_grid

__all__ = [
    "megakernel",
    "tape_kernel",
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
    "GridPack",
    "GridStatic",
    "grid_nearest_hit",
    "pack_grid",
]
