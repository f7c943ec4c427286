"""Host milliseconds a live frame in the program's ``render.tonemap`` span
(program span, traced window)."""

from benchmark.program_spans import tonemap_ms as read  # noqa: F401
