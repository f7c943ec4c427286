"""The live frame as one CUDA graph: captured once, replayed every frame.

An eager non-progressive frame of a sphere scene on the card enqueues
about seventeen launches from Python: the beauty kernel and its segment
sum, the G-buffer cast, the a-trous passes with their planes, the tonemap.
That enqueue takes the host longer than the card takes to run them, so
the card waits on it. A ``FrameGraph`` captures such a frame once into a
``torch.cuda.CUDAGraph`` and replays it each frame: one launch from the
host.

The graph bakes in the body's packed scene and numbers, which its owner
holds fixed for the graph's life. What changes from frame to frame is
read from device memory that the graph owns: the sample offset from a
one-word buffer (``offset``), which the graph advances by ``spp`` after
the beauty launch and the host rewrites only when asked for another
offset, and the camera from a packed row (``camera``), which
``set_camera`` rewrites. Both writes are stream-ordered, so they are safe
with frames in flight. The frame's image and segment count land in one
buffer (``out``), which each replay copies once, so no returned tensor is
the graph's own.

The capture runs the kernel wrappers, which count launches, but launches
nothing; each replay counts the captured frame's launches instead, in
every counter registered with ``kernels/build.py``. ``CAPTURES`` and
``REPLAYS`` count captures and replayed frames in this process.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from ..kernels import build, megakernel

CAPTURES = 0
REPLAYS = 0


def _as_int32(offset: int) -> int:
    """The low 32 bits of ``offset`` as a signed int32 (the kernel reads the
    word as uint32)."""
    v = offset & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


class FrameGraph:
    """One frame of ``spp`` samples a pixel and ``size`` (height, width)
    pixels, captured on ``device`` at the view ``camera``.
    ``body(offset, camera, image)`` enqueues the frame: its kernels read
    the sample offset from the int32 tensor ``offset`` and the view from
    the packed row ``camera``; it writes the uint8 frame into ``image`` and
    returns the rays int64 tensor.

    The capture runs on a stream of its own and waits for nothing on the
    host; an eager frame of the same body has already bound every library
    and set every kernel attribute."""

    def __init__(self, body: Callable[[Tensor, Tensor, Tensor], Tensor], device: torch.device,
                 spp: int, size: tuple[int, int], camera):
        global CAPTURES
        self.spp = spp
        self.offset = torch.zeros(1, dtype=torch.int32, device=device)
        self._word = 0  # what ``offset`` holds when the next replay runs
        self.camera = megakernel.pack_camera(camera)
        h, w = size
        n = h * w * 3
        # the image's bytes, padded to a word, then the rays: one copy a replay
        self.out = torch.empty(-(-n // 8) * 8 + 8, dtype=torch.uint8, device=device)
        self._image = ((h, w, 3), (w * 3, 3, 1))
        self.graph = torch.cuda.CUDAGraph()
        before = build.launch_counts()
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                rays = body(self.offset, self.camera, self.out.as_strided(*self._image))
                self.out.view(torch.int64)[-1:].copy_(rays.reshape(1))
                self.offset.add_(spp)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)
        # the wrappers counted launches that did not run: each replay counts them
        after = build.launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        build.add_launch_counts({k: -n for k, n in self.launches.items()})
        CAPTURES += 1

    def set_camera(self, camera) -> None:
        """Point the frames replayed from now on at ``camera``."""
        self.camera.copy_(megakernel.pack_camera(camera))

    def replay(self, sample_offset: int) -> tuple[Tensor, Tensor]:
        """Enqueue the frame at ``sample_offset``; returns its (uint8 image,
        rays int64 tensor), a copy that later replays leave alone."""
        global REPLAYS
        word = _as_int32(sample_offset)
        if word != self._word:
            self.offset.fill_(word)
        self._word = _as_int32(sample_offset + self.spp)
        self.graph.replay()
        build.add_launch_counts(self.launches)
        REPLAYS += 1
        out = self.out.clone()
        return out.as_strided(*self._image), out.view(torch.int64)[-1]
