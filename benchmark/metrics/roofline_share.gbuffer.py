"""The G-buffer cast's share of its roofline in the traced window
(``roofline.gbuffer_frame``, published H100 peaks)."""

from benchmark.readers import gbuffer_share as read  # noqa: F401
