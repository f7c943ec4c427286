"""What the metric files of ``metrics/`` read, one function per quantity.

Each metric of ``BENCHMARK.json`` is a file ``metrics/<name>.py`` whose
``read(run)`` is one of these (two metrics may read the same quantity in
cells that report different end-to-end metrics). A reader returns None
where the run holds nothing for it, and the metric is then left out of the
result line.
"""

from __future__ import annotations

import statistics

from . import roofline


def mrays_per_s(run):
    """Traced path segments of every frame completed in the window, in
    millions, over the window's wall time (start to the fenced end of its
    last frame, host clock). Segments are the renderer's own count, held
    to the plain reference's by the check."""
    rays = [r for _, r in run.frames if r is not None]
    if not rays or run.window_s <= 0.0:
        return None
    return sum(rays) / run.window_s / 1e6


def frames_per_s(run):
    """Frames delivered to the sink in the window over its wall time."""
    if not run.frames or run.window_s <= 0.0:
        return None
    return len(run.frames) / run.window_s


def frame_ms_p95(run):
    """The 95th percentile of the intervals between consecutive frame
    deliveries, in milliseconds (linear interpolation between order
    statistics)."""
    times = [t for t, _ in run.frames]
    gaps = [b - a for a, b in zip(times, times[1:])]
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=20, method="inclusive")[18] * 1e3


def setup_s(run):
    """Process start to the start of the window."""
    return run.setup_s


def _frame_floor(run, frame_fn) -> float:
    mix = run.mix
    pixels, spp = mix["width"] * mix["height"], mix["spp"]
    n = run.work()["primitives"]
    return sum(roofline.floor_seconds(*frame_fn(r, pixels, spp, n, run.config["sky"]))[0]
               for _, r in run.frames)


def sphere_share(run):
    """The window's frames' sphere-soup floor (each frame from its own
    segment count) over the device time of ``sphere_megakernel``, in %."""
    if run.summary is None:
        return None
    return roofline.share_percent(_frame_floor(run, roofline.sphere_frame),
                                  run.summary.kernel_seconds("sphere_megakernel"))


def tape_share(run):
    """The window's frames' CSG floor over the device time of
    ``tape_kernel``, in %."""
    if run.summary is None:
        return None
    return roofline.share_percent(_frame_floor(run, roofline.tape_frame),
                                  run.summary.kernel_seconds("tape_kernel"))


def atrous_share(run):
    """The filter's floor on the frame's G-buffer (both-hit taps counted on
    the reference's G-buffer) for each frame, over the device time of
    ``atrous_pass``, in %."""
    taps = run.facts.get("both_hit_taps")
    if run.summary is None or taps is None:
        return None
    mix = run.mix
    floor, _ = roofline.floor_seconds(*roofline.atrous_frame(
        mix["width"] * mix["height"], mix["denoise_passes"], taps))
    return roofline.share_percent(floor * len(run.frames),
                                  run.summary.kernel_seconds("atrous_pass"))


def gbuffer_share(run):
    """The G-buffer cast's floor (hits counted on the reference's G-buffer)
    for each frame, over the device time of ``sphere_gbuffer``, in %."""
    hits = run.facts.get("gbuffer_hits")
    if run.summary is None or hits is None:
        return None
    mix = run.mix
    floor, _ = roofline.floor_seconds(*roofline.gbuffer_frame(
        mix["width"] * mix["height"], hits, run.work()["primitives"]))
    return roofline.share_percent(floor * len(run.frames),
                                  run.summary.kernel_seconds("sphere_gbuffer"))


def enqueue_ms(run):
    """Host milliseconds inside ``draw_frame_async``, the mean over every
    frame of the traced window (the benchmark's own wrapper)."""
    if not run.trace or not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)


def idle_share(run):
    """The share of the traced window in which no kernel, copy or memory
    set ran on the device, in % (torch.profiler)."""
    s = run.summary
    if s is None or s.window_s <= 0.0 or s.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
