"""The a-trous filter's pass as a CUDA kernel (``csrc/atrous.cu``).

Replaces no Pallas kernel: the JAX package's filter
(``csgrenderer_tpu/render/denoise.py::atrous_denoise``) is an XLA program
that fuses each pass. In eager torch a pass is about 500 small launches,
so the port fuses it by hand: one launch a pass.

``atrous_passes`` takes CUDA tensors only (ValueError otherwise) and counts
each launch in ``LAUNCHES``; ``render/denoise.py``'s ``atrous_denoise``
calls it for CUDA tensors, between its albedo demodulation and
remodulation, and runs the plain version for CPU tensors. This module takes
plain tensors and numbers, so it imports nothing of ``render/``.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch
from torch import Tensor

from . import build

KERNEL_SOURCE = "atrous"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"pass": 0}

_KERNEL = build.Kernel(
    KERNEL_SOURCE, "csgr_atrous_pass",
    (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_float,) * 3, "a-trous")


def atrous_passes(work: Tensor, normal: Tensor, depth: Tensor, hit: Tensor,
                  passes: Sequence[tuple[int, float, float]], sigma_normal: float) -> Tensor:
    """One launch for each ``(step, 1 / sigma_c^2, 1 / sigma_z^2)`` of
    ``passes`` over [H, W, 3] ``work``, with the AOVs as ``render_aovs``
    gives them: ``normal`` [H, W, 3], ``depth`` [H, W] (+inf on a miss),
    ``hit`` [H, W] bool or uint8, all on one CUDA device. Returns a new
    float32 image (``work`` itself when ``passes`` is empty)."""
    global LAUNCHES
    dev = work.device
    _KERNEL.require_cuda(dev)
    work = work.float().contiguous()
    h, w = work.shape[0], work.shape[1]
    normal = normal.float().contiguous()
    depth = depth.float().contiguous()
    if hit.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"hit has dtype {hit.dtype}, expected bool or uint8")
    hit = hit.contiguous().view(torch.uint8)
    for name, t, shape in (("work", work, (h, w, 3)), ("normal", normal, (h, w, 3)),
                           ("depth", depth, (h, w))):
        build.check_tensor(t, name, torch.float32, shape, dev)
    build.check_tensor(hit, "hit", torch.uint8, (h, w), dev)
    bufs = (torch.empty_like(work), torch.empty_like(work))
    src = work
    for it, (step, inv_sig_c2, inv_sig_z2) in enumerate(passes):
        out = bufs[it % 2]
        _KERNEL(dev, src.data_ptr(), normal.data_ptr(), depth.data_ptr(), hit.data_ptr(),
                out.data_ptr(), h, w, step, inv_sig_c2, inv_sig_z2, float(sigma_normal))
        LAUNCHES += 1
        LAUNCHES_BY_MODE["pass"] += 1
        src = out
    return src
