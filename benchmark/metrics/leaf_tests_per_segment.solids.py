"""Leaf intervals a path segment: the intervals the tape kernel's flip
search computed for every frame completed in the window (the renderer's
count, read at each frame's fence) over those frames' segments. How many
leaves a segment evaluates; every one today, so the scene's leaf count.
None where the program counts no leaf intervals."""


def read(run):
    tests = run.facts.get("leaf_tests")
    rays = [r for _, r in run.frames]
    if (not tests or len(tests) != len(rays) or any(t is None for t in tests)
            or any(r is None for r in rays) or sum(rays) <= 0):
        return None
    return sum(tests) / sum(rays)
