"""The shard canary (kernel row 9): o = 2x on one [8, 128] f32 block.

Twin of the Pallas kernel ``kern`` in tests/test_parallel.py::
test_pallas_vma_checker_still_unsupported. ``scale2_kernel`` launches
``csrc/shard_canary.cu`` for a CUDA tensor (and counts it in ``LAUNCHES``)
and runs ``scale2_plain`` for a CPU tensor; no fallback between them. The
port's tests launch it in every rank of a 2x2 mesh (``parallel``): where
JAX's canary shows that its sharded region cannot yet type a Pallas
kernel, this one shows that a rank launches a hand kernel as any
single-device caller does.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

SHAPE = (8, 128)
KERNEL_SOURCE = "shard_canary"

LAUNCHES = 0
LAUNCHES_BY_MODE = {"scale2": 0}
build.count_launches(__name__, "LAUNCHES", "LAUNCHES_BY_MODE")


def scale2_plain(x: Tensor) -> Tensor:
    """The plain torch version, on any device."""
    return x * 2.0


_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_scale2", (ctypes.c_void_p,) * 2, "canary")


def _launch(x: Tensor) -> Tensor:
    global LAUNCHES
    dev = x.device
    _KERNEL.require_cuda(dev)
    build.check_tensor(x, "x", torch.float32, SHAPE, dev)
    out = torch.empty_like(x)
    _KERNEL(dev, x.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    LAUNCHES_BY_MODE["scale2"] += 1
    return out


def scale2_kernel(x: Tensor) -> Tensor:
    """2x of an [8, 128] f32 tensor: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return scale2_plain(x)
    return _launch(x)
