"""The device's idle share of the traced window in the NEE cell, in %
(torch.profiler)."""

from benchmark.readers import idle_share as read  # noqa: F401
