"""Host milliseconds a live frame in the program's ``render.replay`` span:
the sample offset written, the frame graph replayed and its outputs copied
(program span, traced window); 0 where no frame was replayed."""

from benchmark.program_spans import ms_per_frame


def read(run):
    return ms_per_frame(run, "render.replay")
