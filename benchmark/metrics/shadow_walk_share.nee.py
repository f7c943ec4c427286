"""The share of the sphere kernel's walk turns that NEE's shadow rays take
in its one query loop, in %: their lane turns over all the walk's lane
turns, stats frames (program counters, traced window)."""

from benchmark.program_counters import shadow_walk_share as read  # noqa: F401
