"""Triangle tests a path segment: the Möller-Trumbore tests of every frame
completed in the window (the renderer's count, read at each frame's
fence: the globals, then the faces the walk lists) over those frames'
segments. How well the grid culls; None where the program counts no
triangle tests."""


def read(run):
    tests = run.facts.get("tri_tests")
    rays = [r for _, r in run.frames]
    if (not tests or len(tests) != len(rays) or any(t is None for t in tests)
            or any(r is None for r in rays) or sum(rays) <= 0):
        return None
    return sum(tests) / sum(rays)
