"""The a-trous kernel's share of its roofline in the traced window
(``roofline.atrous_frame``, published H100 peaks)."""

from benchmark.readers import atrous_share as read  # noqa: F401
