"""Branch-free interval-list algebra for CSG boolean combination.

Twin of ``csgrenderer_tpu/render/interval.py``: the value path of the
reference evaluator (``render/tape_eval.py``). A ray's intersection with a
CSG solid is a set of disjoint [t_enter, t_exit) intervals; an *interval
list* is a pair ``(t_in, t_out)`` of shape [..., K], sorted ascending,
disjoint, clipped to [0, T_FAR], with empty slots (T_FAR, T_FAR). K is a
fixed capacity: a combine that would need more spans keeps the nearest K
(``with_dropped`` counts the rest).

Combination is event based: sort the endpoints of both lists (plus a
leading 0), evaluate "inside A" / "inside B" at each inter-event midpoint
by counting, apply the boolean op, mark where the result flips, and
compact the flagged events into K slots with a one-hot masked sum.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import Tensor

from .intersect import T_FAR

# Real surfaces live well below this; boundaries at or above are "at infinity".
SURFACE_CUTOFF = 5e8


def empty_list(batch_shape: tuple, k: int, device=None) -> tuple[Tensor, Tensor]:
    t = torch.full(batch_shape + (k,), T_FAR, dtype=torch.float32, device=device)
    return t, t


def single_to_list(enter: Tensor, exit_: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """One primitive interval (full-line t's) -> clipped K-slot list."""
    enter_c = torch.clamp(enter, 0.0, T_FAR)
    exit_c = torch.clamp(exit_, 0.0, T_FAR)
    valid = enter_c < exit_c
    pad = torch.full(enter.shape + (k - 1,), T_FAR, dtype=torch.float32, device=enter.device)
    t_in = torch.cat([torch.where(valid, enter_c, T_FAR)[..., None], pad], dim=-1)
    t_out = torch.cat([torch.where(valid, exit_c, T_FAR)[..., None], pad], dim=-1)
    return t_in, t_out


def _inside_at(t_in: Tensor, t_out: Tensor, m: Tensor) -> Tensor:
    """inside(m) for query points m [..., M] against a list [..., K] -> [..., M].

    A point is inside iff more enters than exits lie at or before it.
    """
    enters = (t_in[..., None, :] <= m[..., :, None]).sum(dim=-1)
    exits = (t_out[..., None, :] <= m[..., :, None]).sum(dim=-1)
    return enters > exits


def _compact(flags: Tensor, events: Tensor, k: int) -> Tensor:
    """The flagged events, in order, in the first K slots; T_FAR past the end."""
    rank = torch.cumsum(flags.to(torch.int32), dim=-1) - 1
    slots = torch.arange(k, dtype=torch.int32, device=flags.device)
    onehot = flags[..., :, None] & (rank[..., :, None] == slots)  # [..., E, K]
    vals = torch.where(onehot, events[..., :, None], 0.0).sum(dim=-2)
    return torch.where(onehot.any(dim=-2), vals, T_FAR)


def combine(a: tuple[Tensor, Tensor], b: tuple[Tensor, Tensor], op: str,
            k: int | None = None, with_dropped: bool = False):
    """Boolean-combine two interval lists; op in {"union", "intersect", "diff"}.

    ``with_dropped=True`` also returns, per ray, the number of result spans
    that did not fit the K slots (zero: the result is exact).
    """
    a_in, a_out = a
    b_in, b_out = b
    if k is None:
        k = a_in.shape[-1]

    zero = torch.zeros(a_in.shape[:-1] + (1,), dtype=a_in.dtype, device=a_in.device)
    events = torch.sort(torch.cat([zero, a_in, a_out, b_in, b_out], dim=-1), dim=-1).values
    # sample points: midpoint of [e_j, e_j+1); past-the-end for the last
    nxt = torch.cat([events[..., 1:], events[..., -1:] + 1.0], dim=-1)
    mids = 0.5 * (events + nxt)

    in_a = _inside_at(a_in, a_out, mids)
    in_b = _inside_at(b_in, b_out, mids)
    if op == "union":
        inside = in_a | in_b
    elif op == "intersect":
        inside = in_a & in_b
    elif op == "diff":
        inside = in_a & ~in_b
    else:
        raise ValueError(f"unknown op {op!r}")

    prev = torch.cat([torch.zeros_like(inside[..., :1]), inside[..., :-1]], dim=-1)
    starts = inside & ~prev
    ends = ~inside & prev
    t_in = _compact(starts, events, k)
    t_out = _compact(ends, events, k)
    if with_dropped:
        # spans starting at a real surface count toward the capacity
        real = starts & (events < SURFACE_CUTOFF)
        n_spans = real.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        return t_in, t_out, torch.clamp(n_spans - k, min=0)
    return t_in, t_out


union = partial(combine, op="union")
intersect = partial(combine, op="intersect")
difference = partial(combine, op="diff")


def first_surface(t_in: Tensor, t_out: Tensor, eps: float = 1e-3) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest real surface crossing with t > eps.

    Returns (t_hit, entering, hit). Boundaries at t <= eps (a start clipped
    to 0 when the origin is inside) and at infinity are not surfaces.
    """
    def best(ts):
        ok = (ts > eps) & (ts < SURFACE_CUTOFF)
        return torch.where(ok, ts, T_FAR).amin(dim=-1)

    t_enter = best(t_in)
    t_exit = best(t_out)
    t_hit = torch.minimum(t_enter, t_exit)
    return t_hit, t_enter <= t_exit, t_hit < SURFACE_CUTOFF


def inside_at_origin(t_in: Tensor, t_out: Tensor, eps: float = 1e-3) -> Tensor:
    """Whether the ray origin (t ~ 0) is inside the solid."""
    m = torch.full(t_in.shape[:-1] + (1,), eps, dtype=t_in.dtype, device=t_in.device)
    return _inside_at(t_in, t_out, m)[..., 0]
