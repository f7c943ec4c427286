"""Host milliseconds an offline frame in the program's ``render.fence``
span, blocked on the frame's segment count (program span, traced window)."""

from benchmark.program_spans import fence_ms as read  # noqa: F401
