"""Mrays/s of the device-bound offline cells: traced segments of the window's
frames over its wall time (host clock)."""

from benchmark.readers import mrays_per_s as read  # noqa: F401
