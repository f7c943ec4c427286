"""Millions of NEE shadow rays a second: the shadow rays of every frame
completed in the window (the renderer's count, read at each frame's
fence) over the window's wall time (host clock). None where the program
reads no shadow rays back."""


def read(run):
    shadows = run.facts.get("shadow_rays")
    if not shadows or any(s is None for s in shadows) or run.window_s <= 0.0:
        return None
    return sum(shadows) / run.window_s / 1e6
