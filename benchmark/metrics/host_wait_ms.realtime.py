"""Host milliseconds a live frame in ``App.run``'s ``app.readback`` span,
blocked on a frame's fence (program span, traced window)."""

from benchmark.program_spans import readback_ms as read  # noqa: F401
