"""The tape kernel's share of its roofline in the traced window of the 4K
progressive cell (``roofline.tape_frame``, published H100 peaks)."""

from benchmark.readers import tape_share as read  # noqa: F401
