"""The share of a warp's lanes active in the kernel's segment (bounce)
loop, in %: the stats frames' segments over 32 x the loop's warp turns
(program counters, traced window; one launch in eight runs the kernel's
stats instantiation)."""

from benchmark.program_counters import segment_lane_share as read  # noqa: F401
