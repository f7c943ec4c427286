"""Voxel visits a path segment that the mesh walk's occupancy mask answers
without loading the voxel's offsets: the frames' masked visits over their
segments, every recorded frame (program counters, traced window)."""

from benchmark.program_counters import masked_visits_per_segment as read  # noqa: F401
