"""Multi-device rendering: the ("tile", "sample") rank mesh and the sharded
renders over it (twin of ``csgrenderer_tpu/parallel``). ``gather_rows``
assembles a frame from the row slabs; ``launch.run_ranks`` runs a function
on several local ranks."""

from .mesh import (
    SAMPLE_AXIS,
    TILE_AXIS,
    RankMesh,
    initialize_multihost,
    make_mesh,
    single_device_mesh,
)
from .shard import (
    gather_rows,
    render_image_sharded,
    render_scene_sharded,
    render_to_noise_sharded,
)

__all__ = [
    "TILE_AXIS",
    "SAMPLE_AXIS",
    "initialize_multihost",
    "make_mesh",
    "single_device_mesh",
    "render_image_sharded",
    "render_scene_sharded",
    "render_to_noise_sharded",
    "RankMesh",
    "gather_rows",
]
