"""Kernels: the grid packer, the CUDA sphere megakernel and its build.

Launch counts live on the module (``megakernel.LAUNCHES``): read them
there, since a name imported from it would be a copy.
"""

from . import megakernel, worklist
from .megakernel import PackedScene, pack_camera, pack_scene, render_image_kernel, render_image_plain
from .worklist import GridPack, GridStatic, grid_nearest_hit, pack_grid

__all__ = [
    "megakernel",
    "worklist",
    "PackedScene",
    "pack_camera",
    "pack_scene",
    "render_image_kernel",
    "render_image_plain",
    "GridPack",
    "GridStatic",
    "grid_nearest_hit",
    "pack_grid",
]
