"""The share of a warp's lanes active in the kernel's walk loop, in %: the
walk's lane turns over 32 x its warp turns, stats frames (program
counters, traced window)."""

from benchmark.program_counters import walk_lane_share as read  # noqa: F401
