"""Host milliseconds an offline frame in ``render.frame`` outside
``render.fence``: the host's own work in ``draw_frame`` (program spans,
traced window)."""

from benchmark.program_spans import busy_ms as read  # noqa: F401
