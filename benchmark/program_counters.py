"""Per-layer metrics from the program's own counters.

The program records counter samples (``profiling.count`` in
``csgrenderer_tpu_torch.utils.profiling``, each with the number of the
frame it lies in) while its spans record, so in a traced run they cover
the traced window; a run is one process, so the record holds that window's
alone. The renderer records its kernel's work counts at each frame's
fence: ``kernel.segments`` on every frame, other counts where the kernel
counts them, and the stats words (``kernel.segment_warp_steps``, ...) on
the frames whose launch ran the kernel's stats instantiation, one in
eight. A reader divides the sums of two counters over the frames that
record both, so a ratio over stats words reads those frames alone. It
returns None for an untraced run, where nothing was recorded, where the
program records no counters, and where no frame records both.
"""

from __future__ import annotations

SEGMENTS = "kernel.segments"
WARP = 32  # lanes of a warp


def _recorded(run) -> list | None:
    if not run.trace:
        return None
    from csgrenderer_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else None


def by_frame(run) -> dict | None:
    """{frame number: {counter name: the sum of its samples in that frame}}
    of the recorded window, or None where nothing was recorded."""
    recorded = _recorded(run)
    if not recorded:
        return None
    frames: dict = {}
    for c in recorded:
        frame = frames.setdefault(c.frame, {})
        frame[c.name] = frame.get(c.name, 0) + c.value
    return frames


def ratio(run, num: str, den: str, scale: float = 1.0) -> float | None:
    """``scale`` x the sum of counter ``num`` over the sum of counter
    ``den``, both over the frames that record both."""
    frames = by_frame(run)
    if frames is None:
        return None
    both = [f for f in frames.values() if num in f and den in f]
    total = sum(f[den] for f in both)
    if not both or total <= 0:
        return None
    return scale * sum(f[num] for f in both) / total


def segment_lane_share(run):
    """The share of a warp's lanes active in the segment (bounce) loop, in
    %: stats frames' segments over 32 x their segment-loop warp turns."""
    return ratio(run, SEGMENTS, "kernel.segment_warp_steps", 100.0 / WARP)


def walk_steps_per_segment(run):
    """Walk-loop turns a segment: the walk's lane turns over the segments
    of the frames that record them (stats frames on the card)."""
    return ratio(run, "kernel.walk_lane_steps", SEGMENTS)


def walk_lane_share(run):
    """The share of a warp's lanes active in the walk loop, in %: the
    walk's lane turns over 32 x its warp turns, stats frames."""
    return ratio(run, "kernel.walk_lane_steps", "kernel.walk_warp_steps", 100.0 / WARP)


def shadow_walk_share(run):
    """The share of the walk's lane turns that NEE's shadow rays take, in
    %, stats frames."""
    return ratio(run, "kernel.shadow_lane_steps", "kernel.walk_lane_steps", 100.0)


def leaf_scores_per_segment(run):
    """Leaf scores of the attribution through the cluster tree a segment,
    every recorded frame that counts them."""
    return ratio(run, "kernel.leaf_scores", SEGMENTS)


def masked_visits_per_segment(run):
    """Voxel visits the mesh walk's occupancy mask answered a segment,
    every recorded frame that counts them."""
    return ratio(run, "kernel.masked_visits", SEGMENTS)
