"""Micro-experiment: dynamic page-slab extraction, strided rows against a
contiguous block (twin of ``tools/exp_slab.py``).

A table holds 28 pages of a [248, 128] f32 slab, side by side ("lane"
layout, [248, 3584]: page p is columns p*128 .. p*128+127) or one under
the other ("sublane" layout, [28*248, 128]). Over ``n_iter`` dependent
iterations the experiment takes page p(i) and sums its column 7; every
entry of the [8, 128] result is

    sum_i sum_r slab_{p(i)}[r, 7]

with p(i) = (idx[0, 0] + i) mod 28 in modes "lane" and "sublane", and
p(i) = i mod 28 in "loopscalar" and "carryscalar" (which forms it from the
accumulator in the kernel, so each step waits for the last). The kernel
``kernels/csrc/exp_slab.cu`` moves the whole slab into shared memory each
iteration: strided rows against one contiguous block. "lane" and
"sublane" give the same bits, and so do "loopscalar" and "carryscalar".

``slab`` is the wrapper: CUDA tensors launch the kernel (and count in
``LAUNCHES``), CPU tensors run ``slab_plain``. ``slab_numpy`` is the
float64 formula with the tolerance's sum|terms|.

    python -m csgrenderer_tpu_torch.tools.exp_slab [--device cuda|cpu]

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

R = 248  # 2-block chunk slab rows (19 sections x 13 slots + flag)
W = 3584  # 28 pages
LANES = 128
N_PAGES = W // LANES
COL = 7  # the column the TPU's one-hot selected
MODES = ("lane", "sublane", "loopscalar", "carryscalar")  # the JAX script's order
KERNEL_SOURCE = "exp_slab"

LAUNCHES = 0
LAUNCHES_BY_MODE = {m: 0 for m in MODES}


def make_inputs(device="cpu") -> tuple[Tensor, Tensor, Tensor]:
    """(tab_lane [248, 3584] f32, tab_sub [6944, 128] f32, idx [8, 128]
    i32) as the JAX script's main() makes them: numpy ``default_rng(0)``,
    the lane table, its pages stacked, then the page ids."""
    rng = np.random.default_rng(0)
    tab_lane = rng.standard_normal((R, W)).astype(np.float32)
    tab_sub = np.ascontiguousarray(
        tab_lane.reshape(R, N_PAGES, LANES).transpose(1, 0, 2).reshape(N_PAGES * R, LANES))
    idx = rng.integers(0, N_PAGES, (8, LANES)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (tab_lane, tab_sub, idx))


def table_shape(mode: str) -> tuple[int, int]:
    _check_mode(mode)
    return (R, W) if mode == "lane" else (N_PAGES * R, LANES)


def page_ids(mode: str, idx00: int, n_iter: int) -> np.ndarray:
    """p(i) for i < n_iter (int64)."""
    _check_mode(mode)
    start = idx00 if mode in ("lane", "sublane") else 0
    return (start + np.arange(n_iter, dtype=np.int64)) % N_PAGES


def _page_columns(tab, mode: str):
    """Column 7 of every page, [28, 248], of a numpy array or a tensor."""
    if mode == "lane":
        return tab[:, COL::LANES].T
    return tab.reshape(N_PAGES, R, LANES)[:, :, COL]


def slab_numpy(tab, idx, mode: str, n_iter: int) -> tuple[np.ndarray, np.ndarray]:
    """(out [8, 128] float64, sum|terms| [8, 128]) of the formula."""
    tab = np.asarray(tab, np.float64)
    if tab.shape != table_shape(mode):
        raise ValueError(f"mode {mode} takes a {table_shape(mode)} table, got {tab.shape}")
    cols = _page_columns(tab, mode)
    p = page_ids(mode, int(np.asarray(idx)[0, 0]), n_iter)
    full = np.ones((8, LANES))
    return full * cols.sum(axis=1)[p].sum(), full * np.abs(cols).sum(axis=1)[p].sum()


def slab_plain(tab: Tensor, idx: Tensor, mode: str, n_iter: int = N_ITER) -> Tensor:
    """The plain torch version, on any device: column 7's sum of each page,
    taken at each iteration's page and summed over the iterations."""
    _check_mode(mode)
    steps = torch.arange(n_iter, dtype=torch.int64, device=tab.device)
    start = idx[0, 0].to(torch.int64) if mode in ("lane", "sublane") else 0
    p = (start + steps) % N_PAGES
    total = _page_columns(tab, mode).sum(dim=1)[p].sum()
    return total.expand(8, LANES).contiguous()


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


_VP, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_exp_slab", (_VP, _VP, _VP, _I, _I), "slab")


def _launch(tab: Tensor, idx: Tensor, mode: str, n_iter: int) -> Tensor:
    global LAUNCHES
    dev = tab.device
    _KERNEL.require_cuda(dev)
    build.check_tensor(tab, "tab", torch.float32, table_shape(mode), dev)
    build.check_tensor(idx, "idx", torch.int32, (8, LANES), dev)
    out = torch.empty((8, LANES), dtype=torch.float32, device=dev)
    _KERNEL(dev, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n_iter, MODES.index(mode))
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1
    return out


def slab(tab: Tensor, idx: Tensor, mode: str, n_iter: int = N_ITER) -> Tensor:
    """The experiment's [8, 128] f32 result (``tab`` in the mode's layout):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_mode(mode)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if tab.device.type == "cpu":
        return slab_plain(tab, idx, mode, n_iter)
    return _launch(tab, idx, mode, n_iter)


def main(argv=None) -> list[dict]:
    """Each mode held to the plain version and the formula at --n-iter
    (RuntimeError outside the tolerance), the kernel's paired modes to the
    bit, then
    each mode's slope. One row per mode."""
    args = experiment_args(argv, __doc__.splitlines()[0])
    dev = torch.device(args.device)
    tab_lane, tab_sub, idx = make_inputs(dev)
    rows, outs = [], {}
    for mode in MODES:
        tab = tab_lane if mode == "lane" else tab_sub
        run = functools.partial(slab, tab, idx, mode)
        res = check_call(f"exp_slab[{mode}]", run, functools.partial(slab_plain, tab, idx, mode),
                         functools.partial(slab_numpy, tab.cpu().numpy(), idx.cpu().numpy(), mode),
                         args.n_iter, args.reps, dev)
        outs[mode] = res.pop("out")
        t = slope(run, args.n_iter, args.long, args.reps, dev)
        rows.append(dict(mode=mode, device=str(dev), **res, **t,
                         table_bytes=tab.numel() * tab.element_size()))
        print(f"[exp_slab] {mode}: {t['ns_per_iter']:.1f} ns per slab ({args.n_iter} iters "
              f"{t['ms_n1']:.3f} ms, {args.long} iters {t['ms_n2']:.3f} ms; plain "
              f"{res['plain_ms']:.3f} ms; max |err| vs plain {res['max_abs_err']:.3e}, vs "
              f"float64 {res['max_abs_err_f64']:.3e}: {res['tol_ratio']:.3f} x the 1e-6 "
              f"sum|terms| bound){'' if dev.type == 'cuda' else ' [plain, CPU clock]'}",
              flush=True)
    if dev.type == "cuda":  # the kernel's pairs; the plain versions sum in other orders
        require_equal("exp_slab", outs, [("lane", "sublane"), ("loopscalar", "carryscalar")])
    return rows


if __name__ == "__main__":
    main()
