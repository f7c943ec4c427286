"""The sphere kernel's share of its roofline in the traced window
(``roofline.sphere_frame``, published H100 peaks)."""

from benchmark.readers import sphere_share as read  # noqa: F401
