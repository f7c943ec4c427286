"""What the micro-experiments share: slope timing and their tolerance.

Each experiment kernel runs a dependent loop of ``n_iter`` iterations in
one CTA. One call's time includes the launch and the set-up, so the cost
of one iteration is the slope between two loop lengths:
(t(n2) - t(n1)) / (n2 - n1), each t the median of ``reps`` calls timed by
CUDA events (by the host clock for the plain versions on the CPU, which
is no device time).

The experiments' sums are taken in different orders by the kernel, its
plain version, the JAX interpret-mode kernel and a float64 formula, so
each is held to |a - b| <= REL_TOL * sum|terms|, where sum|terms| adds the
absolute value of every table entry the sum reads, with multiplicity.
``check_call`` is the one place where a run is held to its plain version
and the formula: each tool's main() calls it for every run before timing
the slope, and stops at the first run outside the tolerance.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

N_ITER = 2000  # the JAX scripts' loop length
N_ITER_LONG = 42000  # their second length for the slope: 21 x N_ITER
REL_TOL = 1e-6


def experiment_args(argv, description: str) -> argparse.Namespace:
    """The experiments' command line: --device (default cuda, which must be
    present), --n-iter, --long, --reps."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernel (default); cpu: the plain version, for a smoke run")
    ap.add_argument("--n-iter", type=int, default=N_ITER)
    ap.add_argument("--long", type=int, default=N_ITER_LONG, help="second loop length (slope)")
    ap.add_argument("--reps", type=int, default=3, help="calls per length; the median is kept")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available "
                         "(--device cpu runs the plain versions)")
    if not 0 < args.n_iter < args.long:
        raise SystemExit("need 0 < --n-iter < --long")
    return args


def call_ms(run, n_iter: int, reps: int, device: torch.device) -> float:
    """Median over ``reps`` calls of ``run(n_iter)``, in ms: CUDA events on
    a CUDA device, the host clock on the CPU."""
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(n_iter)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run(n_iter)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def slope(run, n1: int, n2: int, reps: int, device: torch.device) -> dict:
    """{"ns_per_iter", "ms_n1", "ms_n2"}: one warm-up call of each length,
    then ``reps`` timed calls of each."""
    run(n1)
    run(n2)
    ms1 = call_ms(run, n1, reps, device)
    ms2 = call_ms(run, n2, reps, device)
    return {"ns_per_iter": (ms2 - ms1) / (n2 - n1) * 1e6, "ms_n1": ms1, "ms_n2": ms2}


def check_call(label: str, kernel, plain, formula, n_iter: int, reps: int,
               device: torch.device) -> dict:
    """Runs ``kernel(n_iter)`` and ``plain(n_iter)``, each once to check
    and then ``reps`` times to time, and holds the kernel's result to the
    plain version's and to ``formula(n_iter)`` = (float64 result,
    sum|terms|). Raises RuntimeError naming ``label`` where either is
    outside REL_TOL * sum|terms| or the result is not finite. Returns
    {"out", "ms", "plain_ms", "max_abs_err" (against the plain version),
    "max_abs_err_f64", "tol_ratio" (the larger of the two ratios)}."""
    out = kernel(n_iter)
    ref_plain = plain(n_iter)
    ref, terms = formula(n_iter)
    got = out.float().cpu().numpy()
    if not np.isfinite(got).all():
        raise RuntimeError(f"{label}: non-finite result")
    err, ratio = agreement(got, ref_plain.float().cpu().numpy(), terms)
    err_f, ratio_f = agreement(got, ref, terms)
    if ratio > 1.0 or ratio_f > 1.0:
        raise RuntimeError(f"{label}: max |err| {err:.3e} against the plain version "
                           f"({ratio:.3f} x the bound) and {err_f:.3e} against float64 "
                           f"({ratio_f:.3f} x); the bound is {REL_TOL} x sum|terms|")
    return {"out": out, "ms": call_ms(kernel, n_iter, reps, device),
            "plain_ms": call_ms(plain, n_iter, reps, device), "max_abs_err": err,
            "max_abs_err_f64": err_f, "tol_ratio": max(ratio, ratio_f)}


def require_equal(tool: str, outs: dict, pairs) -> None:
    """Raises RuntimeError unless ``outs[a]`` and ``outs[b]`` are equal to
    the bit for every (a, b) in ``pairs``."""
    for a, b in pairs:
        if not torch.equal(outs[a], outs[b]):
            raise RuntimeError(f"{tool}: modes {a} and {b} differ (they must agree to the bit)")


def agreement(got, ref, terms_abs) -> tuple[float, float]:
    """(max |got - ref|, max |got - ref| / (REL_TOL * sum|terms|)): the
    second is at most 1 where the tolerance holds."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    return float(err.max()), float((err / (REL_TOL * np.asarray(terms_abs, np.float64))).max())
