"""Frames delivered to the sink in the window over its wall time (host clock)."""

from benchmark.readers import frames_per_s as read  # noqa: F401
