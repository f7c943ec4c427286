"""Host milliseconds a live frame in the program's ``render.launch`` span:
the beauty kernel's wrapper (program span, traced window)."""

from benchmark.program_spans import launch_ms as read  # noqa: F401
