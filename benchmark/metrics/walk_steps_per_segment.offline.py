"""Walk-loop turns a path segment (the sphere grid's cells, the mesh
grid's voxels, the cluster tree's nodes): the walk's lane turns over the
segments of the stats frames (program counters, traced window)."""

from benchmark.program_counters import walk_steps_per_segment as read  # noqa: F401
