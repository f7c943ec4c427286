"""Mrays/s of the progressive path, each frame animated, reclustered and packed
on the host. Kept apart from ``mrays_per_s``: the host sets this cell's
pace and its runs spread far wider than the device-bound cells', so each
takes its own bound."""

from benchmark.readers import mrays_per_s as read  # noqa: F401
