"""Profiling and tracing: device traces and call timing.

Twin of ``csgrenderer_tpu/utils/profiling.py``.

- ``trace(dir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto) of the CPU and,
  where there is one, the CUDA timeline.
- ``time_fn``: first call (build and run) against the steady-state mean,
  with Mrays accounting. Calls whose outputs lie on a CUDA device are
  timed with CUDA events, others with ``time.perf_counter``; either way a
  host readback inside the timed window fences the call.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str = "csgr-trace"):
    """Capture a trace of the block into ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class Timing:
    compile_sec: float  # the first call: kernel builds and the run
    run_sec: float  # per-call mean over the timed calls
    calls: int
    rays: int = 0

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.run_sec / 1e6 if self.run_sec > 0 else 0.0


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for x in out for leaf in _leaves(x)]
    if isinstance(out, dict):
        return [leaf for x in out.values() for leaf in _leaves(x)]
    return [out]


def _fence(out, rays_index):
    """Force completion with a host readback; returns the ray count if
    ``rays_index`` names it."""
    leaves = _leaves(out)
    if rays_index is not None:
        return int(leaves[rays_index])
    first = leaves[0]
    # one element: the transfer stays tiny
    float(first.reshape(-1)[0]) if first.ndim else float(first)
    return 0


def time_fn(fn, *args, calls: int = 3, rays_index: int | None = None) -> Timing:
    """Measure ``fn(*args)``: first call (build + run) vs steady-state mean.

    ``rays_index``: index of a ray-count scalar among fn's output leaves,
    used for the Mrays metric (and as the in-window completion fence).
    """
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out, rays_index)
    compile_sec = time.perf_counter() - t0
    on_cuda = any(isinstance(x, torch.Tensor) and x.is_cuda for x in _leaves(out))

    rays = 0
    times = []
    for _ in range(calls):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            r = _fence(out, rays_index)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            r = _fence(out, rays_index)
            times.append(time.perf_counter() - t0)
        rays += r
    return Timing(
        compile_sec=compile_sec,
        run_sec=sum(times) / len(times) if times else 0.0,
        calls=calls,
        rays=rays // calls if calls else 0,
    )
