"""Micro-experiment: a column gather from shared memory against a product
by a one-hot matrix (twin of ``tools/exp_gather.py``).

For a table ``tab`` [115, 128] f32 and start indices ``idx`` [8, 128] i32
the experiment computes, over ``n_iter`` dependent iterations,

    out[g, j] = sum_i sum_r tab[r, (idx[g, j] + i) & 127]

The TPU asked whether a lane shuffle (``take_along_axis``) beats the
one-hot MXU product for this per-lane gather. Here the kernel
``kernels/csrc/exp_gather.cu`` asks it of an H100: mode "shuffle" reads
the column from shared memory, mode "onehot" forms it as an f32 product
by the [128, 128] one-hot on the CUDA cores; both give the same bits.

``gather`` is the wrapper: CUDA tensors launch the kernel (and count in
``LAUNCHES``), CPU tensors run ``gather_plain``. ``gather_numpy`` is the
float64 formula with the tolerance's sum|terms|.

    python -m csgrenderer_tpu_torch.tools.exp_gather [--device cuda|cpu]

holds each mode to the plain version and the formula, and the paired
modes to each other's bits, then prints each mode's time per iteration,
by slope over n_iter = 2,000 and 42,000 (CUDA events).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import Tensor

from ..kernels import build
from .common import N_ITER, check_call, experiment_args, require_equal, slope

R = 115  # slab rows (19 sections x 6 slots + flag)
LANES = 128
GROUPS = 8
MODES = ("onehot", "shuffle")  # the JAX script's order
KERNEL_SOURCE = "exp_gather"

LAUNCHES = 0
LAUNCHES_BY_MODE = {m: 0 for m in MODES}


def make_inputs(device="cpu") -> tuple[Tensor, Tensor]:
    """(tab [115, 128] f32, idx [8, 128] i32) as the JAX script's main()
    makes them: numpy ``default_rng(0)``, normal then integers."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(R, LANES)).astype(np.float32)
    idx = rng.integers(0, LANES, (GROUPS, LANES)).astype(np.int32)
    return torch.from_numpy(tab).to(device), torch.from_numpy(idx).to(device)


def gather_numpy(tab, idx, n_iter: int) -> tuple[np.ndarray, np.ndarray]:
    """(out [8, 128] float64, sum|terms| [8, 128]) of the formula."""
    tab = np.asarray(tab, np.float64)
    cols = (np.asarray(idx, np.int64)[None] + np.arange(n_iter)[:, None, None]) & (LANES - 1)
    return tab.sum(axis=0)[cols].sum(axis=0), np.abs(tab).sum(axis=0)[cols].sum(axis=0)


def gather_plain(tab: Tensor, idx: Tensor, mode: str, n_iter: int = N_ITER) -> Tensor:
    """The plain torch version, on any device: the row sums of the table,
    gathered at each iteration's columns and summed over the iterations.
    Both modes compute this function (a one-hot product's column is the
    gathered column)."""
    _check_mode(mode)
    steps = torch.arange(n_iter, dtype=torch.int64, device=tab.device)[:, None, None]
    cols = (idx.to(torch.int64)[None] + steps) & (LANES - 1)
    return tab.sum(dim=0)[cols].sum(dim=0)


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


_VP, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_exp_gather", (_VP, _VP, _VP, _I, _I), "gather")


def _launch(tab: Tensor, idx: Tensor, mode: str, n_iter: int) -> Tensor:
    global LAUNCHES
    dev = tab.device
    _KERNEL.require_cuda(dev)
    build.check_tensor(tab, "tab", torch.float32, (R, LANES), dev)
    build.check_tensor(idx, "idx", torch.int32, (GROUPS, LANES), dev)
    out = torch.empty((GROUPS, LANES), dtype=torch.float32, device=dev)
    _KERNEL(dev, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n_iter, MODES.index(mode))
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1
    return out


def gather(tab: Tensor, idx: Tensor, mode: str, n_iter: int = N_ITER) -> Tensor:
    """The experiment's [8, 128] f32 result: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; no fallback between them."""
    _check_mode(mode)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if tab.device.type == "cpu":
        return gather_plain(tab, idx, mode, n_iter)
    return _launch(tab, idx, mode, n_iter)


def main(argv=None) -> list[dict]:
    """Each mode held to the plain version and the formula at --n-iter
    (RuntimeError outside the tolerance), the kernel's two modes to the bit,
    then
    each mode's slope. One row per mode."""
    args = experiment_args(argv, __doc__.splitlines()[0])
    dev = torch.device(args.device)
    tab, idx = make_inputs(dev)
    formula = functools.partial(gather_numpy, tab.cpu().numpy(), idx.cpu().numpy())
    rows, outs = [], {}
    for mode in MODES:
        run = functools.partial(gather, tab, idx, mode)
        plain = functools.partial(gather_plain, tab, idx, mode)
        res = check_call(f"exp_gather[{mode}]", run, plain, formula, args.n_iter, args.reps, dev)
        outs[mode] = res.pop("out")
        t = slope(run, args.n_iter, args.long, args.reps, dev)
        rows.append(dict(mode=mode, device=str(dev), **res, **t,
                         table_bytes=tab.numel() * tab.element_size()))
        print(f"[exp_gather] [{mode}] {t['ns_per_iter']:.1f} ns per iteration "
              f"({t['ns_per_iter'] / GROUPS:.1f} ns per row-gather; {args.n_iter} iters "
              f"{t['ms_n1']:.3f} ms, {args.long} iters {t['ms_n2']:.3f} ms; plain "
              f"{res['plain_ms']:.3f} ms; out[0,0]={float(outs[mode][0, 0]):.3f}, max |err| vs "
              f"plain {res['max_abs_err']:.3e}, vs float64 {res['max_abs_err_f64']:.3e}: "
              f"{res['tol_ratio']:.3f} x the 1e-6 sum|terms| bound)"
              f"{'' if dev.type == 'cuda' else ' [plain, CPU clock]'}", flush=True)
    if dev.type == "cuda":  # the kernel's pairs; the plain versions sum in other orders
        require_equal("exp_gather", outs, [("onehot", "shuffle")])
    return rows


if __name__ == "__main__":
    main()
