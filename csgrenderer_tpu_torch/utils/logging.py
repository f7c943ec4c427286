"""Structured logging with the reference's tag style.

A copy of ``csgrenderer_tpu/utils/logging.py`` (it imports no framework).

The reference printf-logs with ``[Wololo]`` / ``[Wololo][Stats]`` prefixes
and no levels (SURVEY §5); here it's the stdlib ``logging`` module with a
``[csgr]``-prefixed formatter, real levels, and an env switch.
"""

from __future__ import annotations

import logging
import os

_FORMAT = "[csgr]%(tag)s %(message)s"


class _TagFilter(logging.Filter):
    def filter(self, record):
        record.tag = f"[{record.name.split('.')[-1]}]" if record.name else ""
        return True


def get_logger(name: str = "csgr") -> logging.Logger:
    logger = logging.getLogger(f"csgr.{name}" if name != "csgr" else "csgr")
    root = logging.getLogger("csgr")
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_TagFilter())
        root.addHandler(handler)
        root.setLevel(os.environ.get("CSGR_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return logger
