"""Frame-time statistics clock.

A copy of ``csgrenderer_tpu/app/stats.py`` (it imports no framework).

Re-implements the reference's per-second stats reporter (``app.c:126-194``)
with the math fixed: the reference truncates the frame-time sum through a
``size_t`` (printing a 0 mean for sub-second frames, ``app.c:171``) and
prints the *variance* labelled "Stddev" (no sqrt, ``app.c:178-181``). We keep
the reporting cadence and line shape but compute real float mean/stddev, and
add the renderer-centric metric that matters here: Mrays/sec.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class FrameStats:
    frames: int = 0
    dt_sum: float = 0.0
    dt_sqr_sum: float = 0.0
    rays: int = 0

    def push(self, dt_sec: float, rays: int = 0) -> None:
        self.frames += 1
        self.dt_sum += dt_sec
        self.dt_sqr_sum += dt_sec * dt_sec
        self.rays += rays

    @property
    def mean(self) -> float:
        return self.dt_sum / self.frames if self.frames else 0.0

    @property
    def stddev(self) -> float:
        if not self.frames:
            return 0.0
        var = max(self.dt_sqr_sum / self.frames - self.mean**2, 0.0)
        return math.sqrt(var)

    @property
    def fps(self) -> float:
        return self.frames / self.dt_sum if self.dt_sum > 0 else 0.0

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.dt_sum / 1e6 if self.dt_sum > 0 else 0.0

    def report_line(self, elapsed_sec: float) -> str:
        """Same shape as the reference's stats line (app.c:182-187), plus rays."""
        line = (
            f"[csgr][Stats] | {self.frames} frames / {elapsed_sec:.3f} sec = "
            f"{self.fps:.1f} fps | Avg. Frame-Time {self.mean * 1e3:.3f} ms | "
            f"Stddev. Frame-Time {self.stddev * 1e3:.3f} ms |"
        )
        if self.rays:
            line += f" {self.mrays_per_sec:.1f} Mrays/s |"
        return line


@dataclass
class StatsClock:
    """Accumulates frame stats and emits a report once per wall-clock second
    (the reference's cadence, app.c:157-194)."""

    report_every_sec: float = 1.0
    emit: object = print
    _window: FrameStats = field(default_factory=FrameStats)
    _window_start: float | None = None

    def frame(self, dt_sec: float, rays: int = 0, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        if self._window_start is None:
            self._window_start = now
        self._window.push(dt_sec, rays)
        elapsed = now - self._window_start
        if elapsed >= self.report_every_sec:
            if self.emit is not None:
                self.emit(self._window.report_line(elapsed))
            self._window = FrameStats()
            self._window_start = now
