"""Per-layer metrics from the program's own spans.

The program records its spans (``csgrenderer_tpu_torch.utils.profiling``)
while ``torch.profiler`` records, so in a traced run they cover the traced
window; a run is one process, so the record holds that window's alone.
Each reader sums the durations of the spans of some names and divides by
the frames begun (``render.frame`` spans), in milliseconds. It returns
None for an untraced run, where nothing was recorded, and where the
program records no spans.
"""

from __future__ import annotations

FRAME = "render.frame"


def _recorded(run) -> list | None:
    if not run.trace:
        return None
    from csgrenderer_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def ms_per_frame(run, name: str, minus: str | None = None) -> float | None:
    """Host milliseconds a frame inside the spans ``name``, less those
    inside the spans ``minus``."""
    recorded = _recorded(run)
    if not recorded:
        return None
    frames = sum(1 for s in recorded if s.name == FRAME)
    if not frames:
        return None
    ns = sum(s.end_ns - s.start_ns for s in recorded if s.name == name)
    if minus is not None:
        ns -= sum(s.end_ns - s.start_ns for s in recorded if s.name == minus)
    return ns * 1e-6 / frames


def launch_ms(run):
    """``render.launch``: camera pack, checks, allocations, the launch and
    the segment sum."""
    return ms_per_frame(run, "render.launch")


def denoise_ms(run):
    """``render.denoise``: the AOV cast and the a-trous passes enqueued."""
    return ms_per_frame(run, "render.denoise")


def tonemap_ms(run):
    """``render.tonemap``: tonemap and the uint8 conversion enqueued."""
    return ms_per_frame(run, "render.tonemap")


def readback_ms(run):
    """``app.readback``: ``App.run`` blocked on a frame's readback."""
    return ms_per_frame(run, "app.readback")


def fence_ms(run):
    """``render.fence``: ``draw_frame`` blocked on the frame's segment
    count."""
    return ms_per_frame(run, "render.fence")


def busy_ms(run):
    """``render.frame`` less ``render.fence``: the host's own work in
    ``draw_frame``."""
    return ms_per_frame(run, FRAME, minus="render.fence")
