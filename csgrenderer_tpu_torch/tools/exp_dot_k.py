"""Micro-experiment: the cost of a narrow-page serve, k page slabs times a
one-hot on the tensor cores, against direct loads (twin of
``tools/exp_dot_k.py``).

A bf16 table ``tab`` [32 * rr_pad, 128] holds 32 pages of ``rr_pad`` rows.
Each of ``n_iter`` dependent iterations takes k slabs [rr_pad, pw] at pages
p(i, j), multiplies their concatenation by the one-hot [k*pw, 128] whose
row j*pw + q is 1 where q == j, sums the product's rows and accumulates.
Every entry of the [8, 128] result is

    sum_i sum_{j<k} sum_{r<rr_pad} tab[p(i, j) * rr_pad + r, j]

with p = (i*k + j) mod 32, or p = j mod 32 in "static_slab". Modes (the
JAX script's variants, then this port's own):

- "base": the one-hot built every iteration, one bf16 product of depth
  k*pw on the tensor cores (f32 accumulate);
- "kdots": k products of depth pw, summed;
- "hoist_onehot": the one-hot built once;
- "static_slab": the pages compile-time constants;
- "vote": base plus the block-form page vote, whose row 0 enters the sum
  times 1e-20;
- "direct": no product: the columns read by loads.

The kernel ``kernels/csrc/exp_dot_k.cu`` writes the product by hand
(``nvcuda::wmma``, mma.sync). ``dot_k`` is the wrapper: CUDA tensors
launch the kernel (and count in ``LAUNCHES``), CPU tensors run
``dot_k_plain``. ``dot_k_numpy`` is the float64 formula with the
tolerance's sum|terms|.

    python -m csgrenderer_tpu_torch.tools.exp_dot_k [--device cuda|cpu]

runs the JAX script's (rr_pad, pw, k, variant) combos, then "direct" at
each of their shapes (on the first table of that shape), holds each run
to the plain version and the formula, and prints the time per serve by
slope over n_iter = 2,000 and 42,000 (CUDA events).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch import Tensor

from ..kernels import build
from .common import N_ITER, check_call, experiment_args, slope

N_PAGES = 32
LANES = 128
MODES = ("base", "kdots", "hoist_onehot", "static_slab", "vote", "direct")
KERNEL_SHAPES = ((32, 4), (32, 8), (64, 4), (64, 8))  # (pw, k) the kernel is built for
MAX_ROWS = 256
KERNEL_SOURCE = "exp_dot_k"
# (rr_pad, pw, k, variant): the JAX script's combos, in its order (rr 248 =
# q13, 120 = q6, 64 = q3)
COMBOS = (
    (248, 64, 4, "base"),
    (248, 64, 4, "kdots"),
    (248, 64, 4, "hoist_onehot"),
    (248, 64, 4, "static_slab"),
    (248, 32, 4, "kdots"),
    (248, 32, 4, "hoist_onehot"),
    (248, 64, 8, "kdots"),
    (248, 64, 4, "vote"),
    (248, 32, 8, "vote"),
    (64, 32, 8, "base"),
    (64, 32, 8, "vote"),
)

LAUNCHES = 0
LAUNCHES_BY_MODE = {m: 0 for m in MODES}
LAUNCHES_BY_RUN: dict[tuple, int] = {}  # (rr_pad, pw, k, mode) -> launches


def make_inputs(device="cpu") -> tuple[Tensor, list[tuple[tuple, Tensor]]]:
    """(idx [8, 128] i32, [(combo, tab [32 * rr_pad, 128] bf16), ...]) as
    the JAX script's main() makes them: numpy ``default_rng(0)``, the page
    ids, then one standard-normal table per combo in order, rounded to
    bf16 through float32 (as ml_dtypes rounds a float64). The "direct"
    combos follow, one per (rr_pad, pw, k), each on the first table of
    that shape."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N_PAGES, (8, LANES)).astype(np.int32)).to(device)
    runs, first = [], {}
    for combo in COMBOS:
        rr_pad = combo[0]
        tab = rng.standard_normal((N_PAGES * rr_pad, LANES)).astype(np.float32)
        tab = torch.from_numpy(tab).to(torch.bfloat16).to(device)
        runs.append((combo, tab))
        first.setdefault(combo[:3], tab)
    runs += [((*shape, "direct"), tab) for shape, tab in first.items()]
    return idx, runs


def page_ids(mode: str, k: int, n_iter: int) -> np.ndarray:
    """p(i, j), [n_iter, k] int64."""
    _check_mode(mode)
    j = np.arange(k, dtype=np.int64)[None, :]
    if mode == "static_slab":
        return np.broadcast_to(j % N_PAGES, (n_iter, k))
    return (np.arange(n_iter, dtype=np.int64)[:, None] * k + j) % N_PAGES


def vote_row0(idx, k: int) -> np.ndarray:
    """Row 0 of the block vote over the page tile ``idx`` [8, 128]: k
    passes, each marking the entries equal to the row's minimum of what is
    left with 0 and the rest with -1, summed ([128] float)."""
    pg = np.asarray(idx, np.float32)[0]
    rem, extra = pg.copy(), np.zeros_like(pg)
    for _ in range(k):
        low = rem.min()
        sel = pg == low
        rem = np.where(sel, np.float32(1e9), rem)
        extra = extra + np.where(sel, pg - low, np.float32(-1.0))
    return extra


def _terms(tab, rr_pad: int, k: int, mode: str, n_iter: int):
    """The values the sum reads, [n_iter, k, rr_pad] (numpy or torch, as
    ``tab``): tab[p(i, j) * rr_pad + r, j]."""
    p = page_ids(mode, k, n_iter)
    rows = p[:, :, None] * rr_pad + np.arange(rr_pad)[None, None, :]
    cols = np.broadcast_to(np.arange(k)[None, :, None], rows.shape).copy()
    if isinstance(tab, np.ndarray):
        return tab[rows, cols]
    return tab[torch.from_numpy(rows).to(tab.device), torch.from_numpy(cols).to(tab.device)]


def dot_k_numpy(tab, idx, rr_pad: int, pw: int, k: int, mode: str, n_iter: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(out [8, 128] float64, sum|terms| [8, 128]) of the formula, the vote
    term included."""
    _check_shape(tab.shape, rr_pad, pw, k)
    vals = _terms(np.asarray(tab, np.float64), rr_pad, k, mode, n_iter)
    out = np.full((8, LANES), vals.sum())
    if mode == "vote":
        out = out + n_iter * 1e-20 * vote_row0(idx, k).astype(np.float64)[None, :]
    return out, np.full((8, LANES), np.abs(vals).sum())


def dot_k_plain(tab: Tensor, idx: Tensor, rr_pad: int, pw: int, k: int, mode: str,
                n_iter: int = N_ITER) -> Tensor:
    """The plain torch version, on any device: the table entries the
    product selects, summed per iteration in float32, then over the
    iterations, each iteration's vote term (mode "vote") beside its sum."""
    _check_mode(mode)
    _check_shape(tuple(tab.shape), rr_pad, pw, k)
    per_iter = _terms(tab, rr_pad, k, mode, n_iter).to(torch.float32).sum(dim=(1, 2))
    if mode == "vote":
        extra = torch.from_numpy(vote_row0(idx.cpu().numpy(), k)).to(tab.device)
        per_iter = per_iter[:, None] + extra[None, :] * 1e-20
    else:
        per_iter = per_iter[:, None].expand(n_iter, LANES)
    return per_iter.sum(dim=0).expand(8, LANES).contiguous()


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _check_shape(shape, rr_pad, pw, k):
    if tuple(shape) != (N_PAGES * rr_pad, LANES) or not 0 < k <= pw <= LANES:
        raise ValueError(f"tab {tuple(shape)} for rr_pad={rr_pad}, pw={pw}, k={k}: expected "
                         f"({N_PAGES * rr_pad}, {LANES}) and 0 < k <= pw <= {LANES}")


_VP, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = build.Kernel(KERNEL_SOURCE, "csgr_exp_dot_k", (_VP, _VP, _VP) + (_I,) * 5, "dot_k")


def _launch(tab, idx, rr_pad, pw, k, mode, n_iter) -> Tensor:
    global LAUNCHES
    dev = tab.device
    _KERNEL.require_cuda(dev)
    if (pw, k) not in KERNEL_SHAPES or rr_pad % 8 or not 0 < rr_pad <= MAX_ROWS:
        raise ValueError(f"the kernel takes (pw, k) in {KERNEL_SHAPES} and rr_pad a multiple "
                         f"of 8 up to {MAX_ROWS}, got pw={pw}, k={k}, rr_pad={rr_pad}")
    build.check_tensor(tab, "tab", torch.bfloat16, (N_PAGES * rr_pad, LANES), dev)
    build.check_tensor(idx, "idx", torch.int32, (8, LANES), dev)
    out = torch.empty((8, LANES), dtype=torch.float32, device=dev)
    _KERNEL(dev, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rr_pad, pw, k, n_iter,
            MODES.index(mode))
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1
    LAUNCHES_BY_RUN[(rr_pad, pw, k, mode)] = LAUNCHES_BY_RUN.get((rr_pad, pw, k, mode), 0) + 1
    return out


def dot_k(tab: Tensor, idx: Tensor, rr_pad: int, pw: int, k: int, mode: str,
          n_iter: int = N_ITER) -> Tensor:
    """The experiment's [8, 128] f32 result: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; no fallback between them."""
    _check_mode(mode)
    _check_shape(tuple(tab.shape), rr_pad, pw, k)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if tab.device.type == "cpu":
        return dot_k_plain(tab, idx, rr_pad, pw, k, mode, n_iter)
    return _launch(tab, idx, rr_pad, pw, k, mode, n_iter)


def main(argv=None) -> list[dict]:
    """Every run (combo and mode) held to the plain version and the formula
    at --n-iter (RuntimeError outside the tolerance), then its slope. One
    row per run."""
    args = experiment_args(argv, __doc__.splitlines()[0])
    dev = torch.device(args.device)
    idx, runs = make_inputs(dev)
    rows = []
    for (rr_pad, pw, k, mode), tab in runs:
        shape = (rr_pad, pw, k, mode)
        res = check_call(f"exp_dot_k[{mode} rr{rr_pad} pw{pw} k{k}]",
                         functools.partial(dot_k, tab, idx, *shape),
                         functools.partial(dot_k_plain, tab, idx, *shape),
                         functools.partial(dot_k_numpy, tab.float().cpu().numpy(),
                                           idx.cpu().numpy(), *shape),
                         args.n_iter, args.reps, dev)
        del res["out"]
        t = slope(functools.partial(dot_k, tab, idx, *shape), args.n_iter, args.long, args.reps,
                  dev)
        macs = rr_pad * pw * k * LANES
        rows.append(dict(rr_pad=rr_pad, pw=pw, k=k, mode=mode, device=str(dev), **res, **t,
                         macs=macs, table_bytes=tab.numel() * tab.element_size()))
        ns = t["ns_per_iter"]
        print(f"[exp_dot_k] rr={rr_pad} pw={pw} k={k} {mode:>12}: {ns:9.1f} ns/serve "
              f"({macs / 1e6:5.2f} MMAC, {macs / max(ns, 1e-9) / 1e3:7.3f} TMAC/s; plain "
              f"{res['plain_ms']:.3f} ms; max |err| vs plain {res['max_abs_err']:.3e}, vs "
              f"float64 {res['max_abs_err_f64']:.3e}: {res['tol_ratio']:.3f} x the 1e-6 "
              f"sum|terms| bound){'' if dev.type == 'cuda' else ' [plain, CPU clock]'}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
