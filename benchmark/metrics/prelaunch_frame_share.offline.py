"""The share of the traced window's frames (``render.frame`` spans) that
hold a ``render.prelaunch`` span, in %: the progressive frames that
enqueued the next frame's kernel before waiting on their own (program
spans, traced window); 0 where none did."""

from benchmark.program_spans import FRAME, _recorded


def read(run):
    recorded = _recorded(run)
    if not recorded:
        return None
    frames = [s for s in recorded if s.name == FRAME]
    if not frames:
        return None
    queued = set()
    for s in recorded:
        if s.name == "render.prelaunch":
            parent = s.parent
            while parent is not None and recorded[parent].name != FRAME:
                parent = recorded[parent].parent
            if parent is not None:
                queued.add(parent)
    return 100.0 * len(queued) / len(frames)
