"""Leaf scores a path segment of the tape kernel's attribution through the
cluster tree: the frames' leaf scores over their segments, every recorded
frame (program counters, traced window)."""

from benchmark.program_counters import leaf_scores_per_segment as read  # noqa: F401
