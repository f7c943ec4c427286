"""Host milliseconds inside ``draw_frame_async``, the mean over the traced
window's frames (the benchmark's wrapper, host clock)."""

from benchmark.readers import enqueue_ms as read  # noqa: F401
