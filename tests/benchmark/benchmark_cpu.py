"""Tiny runs of the benchmark's cells on the CPU, for its tests.

On CPU tensors the program runs its kernels' plain torch versions, so the
whole harness (set-up, window, check against the reference, result line)
runs here at a few hundred pixels; only the look for a card is skipped.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

TINY = {
    "rtiow-offline-1080p64": {"width": 32, "height": 18, "spp": 2, "warm_frames": 1},
    "deepcsg-offline-1080p64": {"width": 32, "height": 18, "spp": 2, "warm_frames": 1},
    "deepcsg-progressive-4k2": {"width": 48, "height": 27, "spp": 2, "warm_frames": 1},
    "rtiow-realtime-denoised-720p2": {"width": 32, "height": 18, "spp": 2, "warm_frames": 2},
}
SEED = 2**31 + 977  # past 32 signed bits, as a seed may be


def spec() -> dict:
    """BENCHMARK.json with the entries of the cells held back from it (a
    cell file's ``held_back``), so that their files are run too."""
    s = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((REPO / "benchmark" / "workloads").glob("*.json")):
        held = json.loads(path.read_text()).get("held_back")
        for key in ("workloads", "end_to_end", "per_layer") if held else ():
            s[key] += held[key]
    return s


def tiny_run(name: str, seed: int = SEED, seconds: float = 0.6, trace: bool = False):
    """A Run of cell ``name`` at its tiny size, executed on the CPU in one
    thread (the tests' workers share the host's cores), with a window of
    some frames: a frame takes milliseconds to tens of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = harness.find(name, spec=spec(), mix_overrides=TINY[name], seed=seed,
                           seconds=seconds, trace=trace, device=torch.device("cpu"),
                           t_start=time.perf_counter())
        harness.execute(run)
    finally:
        torch.set_num_threads(threads)
    return run
