"""The 95th percentile of the intervals between consecutive frame deliveries
in the window, in milliseconds (host clock)."""

from benchmark.readers import frame_ms_p95 as read  # noqa: F401
