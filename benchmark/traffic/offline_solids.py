"""Offline progressive rendering of a CSG tape: ``offline_progressive``
with the tape kernel's leaf-interval count recorded.

It changes two things of ``offline_progressive`` and takes the rest (the
renderer, the closed loop, its window, the rows and frames the check
samples, the reference's render through the configuration's
``reference_scene`` and the four numbers it compares) as they are:

- a program whose renderer does not count the leaf intervals of a frame
  (``PathTraceRenderer.last_frame_leaf_tests``) is refused at set-up,
  before any frame;
- each window frame's leaf intervals, which the renderer reads at the same
  fence as its segments, are recorded in ``run.facts["leaf_tests"]`` (one
  count a frame, beside ``run.frames``).
"""

from __future__ import annotations

from benchmark.traffic import offline_progressive as progressive

SPANS = progressive.SPANS
window = progressive.window
release = progressive.release
check = progressive.check
control = progressive.control


def setup(run) -> None:
    r = progressive._renderer(run)
    if not hasattr(r, "last_frame_leaf_tests"):
        raise RuntimeError("the program does not count a frame's leaf intervals "
                           "(PathTraceRenderer.last_frame_leaf_tests): nothing to read them by")
    for _ in range(run.mix["warm_frames"]):
        r.draw_frame(run.config["time"])
    progressive._sync(run)
    r.reset_accumulation()
    tests = run.facts["leaf_tests"] = []
    draw = r.draw_frame

    def draw_frame(time_sec):
        image = draw(time_sec)
        tests.append(r.last_frame_leaf_tests)
        return image

    r.draw_frame = draw_frame
    run.state = r
