"""The numbers that decide ``correct``, each beside its limit.

A check passes when its number is at most its limit. The limits are the
cell file's (``benchmark/workloads/<cell>.json``, key ``limits``), each set
between the readings of sound runs and of the lower-precision control
(``PERF.md`` gives the readings).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

DIVERGENT = 0.05  # a pixel whose radiance differs by more than this in a channel diverges
LEVELS = 1  # a delivered pixel off by more than this many uint8 levels in a channel is off


@dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def divergent(program: torch.Tensor, reference: torch.Tensor) -> tuple[int, int]:
    """(pixels whose radiance differs by more than ``DIVERGENT`` in some
    channel, or is not finite; pixels compared), of [..., 3] images."""
    diff = (program.double() - reference.double()).abs()
    bad = ~torch.isfinite(diff).all(dim=-1) | (diff.nan_to_num(math.inf).amax(dim=-1) > DIVERGENT)
    return int(bad.sum()), bad.numel()


def off_levels(program: torch.Tensor, reference: torch.Tensor) -> tuple[int, int]:
    """(pixels off by more than ``LEVELS`` in some channel, pixels compared),
    of uint8 [..., 3] images."""
    diff = (program.to(torch.int16) - reference.to(torch.int16)).abs()
    bad = diff.amax(dim=-1) > LEVELS
    return int(bad.sum()), bad.numel()


def share(counts) -> float:
    """Summed (bad, total) pairs as a fraction."""
    counts = list(counts)
    bad = sum(b for b, _ in counts)
    total = sum(t for _, t in counts)
    return bad / total if total else math.inf


def relative_gap(program: float, reference: float) -> float:
    return abs(float(program) - float(reference)) / max(abs(float(reference)), 1.0)


def checks(values: dict, limits: dict) -> list[Check]:
    """Every number of ``values`` beside its limit; a number without a
    limit, or a limit without a number, is a fault of the harness."""
    if set(values) != set(limits):
        raise KeyError(f"checks {sorted(values)} against limits {sorted(limits)}")
    return [Check(k, float(values[k]), float(limits[k])) for k in values]
