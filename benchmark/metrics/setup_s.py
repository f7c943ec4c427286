"""Process start to the start of the window: imports, the CUDA context, the
cell's kernels loaded (built, in a checkout's first run), the scene built
and packed, and the warm-up frames (host clock)."""

from benchmark.readers import setup_s as read  # noqa: F401
