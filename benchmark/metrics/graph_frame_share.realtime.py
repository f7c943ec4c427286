"""The share of the traced window's frames (``render.frame`` spans) that
hold a ``render.replay`` span, in %: the frames replayed from a CUDA graph
(program spans, traced window); 0 where none was."""

from benchmark.program_spans import FRAME, _recorded


def read(run):
    recorded = _recorded(run)
    if not recorded:
        return None
    frames = [s for s in recorded if s.name == FRAME]
    if not frames:
        return None
    replayed = set()
    for s in recorded:
        if s.name == "render.replay":
            parent = s.parent
            while parent is not None and recorded[parent].name != FRAME:
                parent = recorded[parent].parent
            if parent is not None:
                replayed.add(parent)
    return 100.0 * len(replayed) / len(frames)
