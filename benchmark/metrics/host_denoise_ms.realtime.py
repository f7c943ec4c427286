"""Host milliseconds a live frame in the program's ``render.denoise`` span:
the G-buffer cast and the a-trous passes enqueued (program span, traced
window)."""

from benchmark.program_spans import denoise_ms as read  # noqa: F401
