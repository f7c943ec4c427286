"""The a-trous filter's pass as a CUDA kernel (``csrc/atrous.cu``).

Replaces no Pallas kernel: the JAX package's filter
(``csgrenderer_tpu/render/denoise.py::atrous_denoise``) is an XLA program
that fuses each pass. In eager torch a pass is about 500 small launches,
so the port fuses it by hand: one launch a pass.

``atrous_passes`` takes CUDA tensors only (ValueError otherwise) and counts
each launch in ``LAUNCHES``; ``render/denoise.py``'s ``atrous_denoise``
calls it for CUDA tensors and runs the plain version for CPU tensors. The
first pass packs the colour (demodulated by the albedo where one is given)
with its luminance, and the normal with the depth, into two float4 planes
that the later passes read; the last remodulates. This module takes plain
tensors and numbers, and imports nothing of ``render/`` when it is
imported.
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
build.count_launches(__name__, "LAUNCHES", "LAUNCHES_BY_MODE")

_KERNEL = build.Kernel(
    KERNEL_SOURCE, "csgr_atrous_pass",
    (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + (ctypes.c_float,) * 3, "a-trous")


def atrous_passes(work: Tensor, normal: Tensor, depth: Tensor, hit: Tensor,
                  passes: Sequence[tuple[int, float, float]], sigma_normal: float,
                  albedo: Tensor | None = None) -> Tensor:
    """One launch for each ``(step, 1 / sigma_c^2, 1 / sigma_z^2)`` of
    ``passes`` over the [H, W, 3] image ``work``, with the AOVs as
    ``render_aovs`` gives them: ``normal`` [H, W, 3], ``depth`` [H, W]
    (+inf on a miss), ``hit`` [H, W] bool or uint8, all on one CUDA device.
    With ``albedo`` [H, W, 3] the passes filter ``work`` divided by the
    albedo clamped at 1e-4 and the result is multiplied by it again
    (``atrous_denoise(demodulate=True)``). Returns a new float32 image
    (``work`` as float32 when ``passes`` is empty)."""
    global LAUNCHES
    # imported here: render/ imports this package, so not at module level
    from ..render.denoise import normal_squarings

    dev = work.device
    _KERNEL.require_cuda(dev)
    work = work.float().contiguous()
    if not passes:
        return work
    h, w = work.shape[0], work.shape[1]
    normal = normal.float().contiguous()
    depth = depth.float().contiguous()
    if hit.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"hit has dtype {hit.dtype}, expected bool or uint8")
    hit = hit.contiguous().view(torch.uint8)
    tensors = [("work", work, (h, w, 3)), ("normal", normal, (h, w, 3)), ("depth", depth, (h, w))]
    if albedo is not None:
        albedo = albedo.float().contiguous()
        tensors.append(("albedo", albedo, (h, w, 3)))
    for name, t, shape in tensors:
        build.check_tensor(t, name, torch.float32, shape, dev)
    build.check_tensor(hit, "hit", torch.uint8, (h, w), dev)
    # float4 planes: the colour with its luminance (two, one pass writes what
    # the next reads) and the normal with its depth; the last pass's image
    bufs = tuple(torch.empty((h, w, 4), dtype=torch.float32, device=dev) for _ in range(2))
    guide = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    image = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    squarings = normal_squarings(sigma_normal)
    albedo_ptr = None if albedo is None else albedo.data_ptr()
    src = None
    for it, (step, inv_sig_c2, inv_sig_z2) in enumerate(passes):
        first, last = it == 0, it == len(passes) - 1
        out = bufs[it % 2]
        _KERNEL(dev, work.data_ptr(), albedo_ptr, normal.data_ptr(), depth.data_ptr(),
                None if first else src.data_ptr(), guide.data_ptr(), hit.data_ptr(),
                out.data_ptr(), guide.data_ptr(), image.data_ptr(), h, w, step, int(first),
                int(last), int(albedo is not None), squarings, inv_sig_c2, inv_sig_z2,
                float(sigma_normal))
        LAUNCHES += 1
        LAUNCHES_BY_MODE["pass"] += 1
        src = out
    return image
