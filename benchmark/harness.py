"""The benchmark's harness: finds a cell's files by name, runs it, prints
its result line.

Everything a cell is made of is a file found by a name in
``BENCHMARK.json``, so a later change adds a cell, a configuration, a
traffic mix or a metric by adding files and entries, without editing a
file that is here:

- ``workloads/<cell>.json``: the cell's configuration and traffic names,
  its camera (keys that replace the configuration's), what its
  correctness check samples, and the limit of each number it compares;
- ``configs/<config>.json`` and ``configs/<config>.py``: the configuration
  as it is run, and beside it the module that builds its scene for the
  program (``program_scene``) and for the plain reference
  (``reference_scene``), and says what a roofline floor reads of it
  (``work``);
- ``traffic/<mix>.json``: the traffic mix's parameters, naming its driver
  ``traffic/<driver>.py``, which sets the program up, drives the measured
  window and checks what it produced (``SPANS``, ``setup``, ``window``,
  ``release``, ``check``);
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``, which
  returns the metric's value or None where the run has nothing for it
  (the metric is then left out of the line).

A run: set-up (imports, the CUDA context, the kernels loaded or built,
the scene built and packed, warm-up frames), then the window of
``--seconds`` (with ``--trace 1``, at most ``TRACE_SECONDS`` of it, under
``torch.profiler``), then the peak
of device memory, then the program's state freed and the correctness
check against the plain reference, then the result line: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``), and last the compared numbers with their limits.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .compare import Check
from .devicetrace import Summary, Tracer

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
RENDER_SEED_MASK = 0xFFFFFFFF  # the renderer's counters are 32 bits wide
# a traced run profiles this much of the window at most: a live frame makes
# about a hundred profiler events, so a whole window would make millions
TRACE_SECONDS = 5.0


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (files named after a
    metric hold dots, so they are loaded by path, not by package)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """One run of one cell: what the harness found, and what the run
    measured, captured and checked."""

    name: str
    entry: dict  # the cell's entry of BENCHMARK.json
    cell: dict  # workloads/<cell>.json
    mix: dict  # traffic/<mix>.json, with any overrides
    config: dict  # configs/<config>.json
    config_module: object
    driver: object
    spec: dict  # BENCHMARK.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # process start, on the perf_counter clock
    root: Path = HERE
    setup_s: float = 0.0
    t0: float = 0.0  # window start and end, perf_counter
    t1: float = 0.0
    frames: list = field(default_factory=list)  # (delivery time, segments or None) a frame
    enqueue_s: list = field(default_factory=list)  # host seconds inside each frame's dispatch
    state: object = None  # the traffic driver's program objects
    captures: dict = field(default_factory=dict)  # what the check compares
    facts: dict = field(default_factory=dict)  # what the check learned for the floors
    summary: Summary | None = None
    memory_peak_bytes: int = 0
    checks: list = field(default_factory=list)
    check_s: float = 0.0  # the reference's comparison, after the window

    @property
    def render_seed(self) -> int:
        return self.seed & RENDER_SEED_MASK

    @property
    def loop_seconds(self) -> float:
        """How long the traffic driver's loop runs: ``seconds``, or in a traced run
        at most ``TRACE_SECONDS``."""
        return min(self.seconds, TRACE_SECONDS) if self.trace else self.seconds

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def work(self) -> dict:
        return self.config_module.work(self.config)


def find(name: str, root: Path = HERE, spec: dict | None = None, mix_overrides: dict | None = None,
         **run_args) -> Run:
    """The Run of cell ``name``, its files found under ``root``."""
    spec = read_json(root.parent / "BENCHMARK.json") if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell = read_json(root / "workloads" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json on its "
                         f"configuration or traffic")
    mix = {**read_json(root / "traffic" / f"{entry['traffic']}.json"), **(mix_overrides or {})}
    config = read_json(root / "configs" / f"{entry['config']}.json")
    config_module = load_module(root / "configs" / f"{entry['config']}.py",
                                f"benchmark_config_{entry['config']}")
    driver = load_module(root / "traffic" / f"{mix['driver']}.py",
                         f"benchmark_traffic_{mix['driver']}")
    return Run(name=name, entry=entry, cell=cell, mix=mix, config=config,
               config_module=config_module, driver=driver, spec=spec, root=root, **run_args)


def camera(config: dict, cell: dict) -> dict:
    """Camera.look_at's keyword arguments: the configuration's camera with
    the cell's keys over it; an orbit (radius, height, angle) gives
    lookfrom = (r sin a, h, r cos a)."""
    c = {**config["camera"], **cell.get("camera", {})}
    if "orbit_radius" in c:
        r, a = c["orbit_radius"], c["orbit_angle"]
        lookfrom = (r * math.sin(a), c["height"], r * math.cos(a))
    else:
        lookfrom = tuple(c["lookfrom"])
    return dict(lookfrom=lookfrom, lookat=tuple(c["lookat"]), vfov_degrees=c["vfov"],
                aperture=c.get("aperture", 0.0), focus_dist=c.get("focus_dist"))


def metrics_for(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones, each where its ``workloads`` names the
    cell or, without that key, where the cell reports the metric it moves."""
    if not trace:
        return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in metrics_for(spec, cell, False)}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def read_metrics(run: Run) -> dict:
    out = {}
    for m in metrics_for(run.spec, run.name, run.trace):
        reader = load_module(run.root / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(run: Run) -> None:
    """Set up, measure, read the peak, free the program, check."""
    tracer = Tracer(run.trace)
    run.driver.setup(run)
    with tracer.window():
        run.driver.window(run, tracer)
    run.setup_s = run.t0 - run.t_start
    run.summary = tracer.summary(run.driver.SPANS)
    tracer.prof = None
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.driver.release(run)
    run.state = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.checks = run.driver.check(run)
    run.check_s = time.perf_counter() - t_check


def power_limit() -> str | None:
    """GPU 0's power limit as nvidia-smi reads it ("700.00 W")."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def result(run: Run) -> dict:
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": int(run.entry["chips"]), "memory_peak_bytes": run.memory_peak_bytes}
    if run.device.type == "cuda":
        device["power_limit"] = power_limit()
    if run.summary is not None:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
    out = {"correct": bool(run.frames) and all(c.ok for c in run.checks),
           "attempted": len(run.frames), "failed": 0,
           "metrics": read_metrics(run), "device": device}
    if run.summary is not None:
        out["breakdown"] = run.summary.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = read_json(REPO / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"error: BENCHMARK.json has no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"error: the cell needs {entry['chips']} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: nothing measured",
              file=sys.stderr)
        return 3
    run = find(args.workload, spec=spec, seed=args.seed, seconds=args.seconds,
               trace=bool(args.trace), device=torch.device("cuda", 0), t_start=t_start)
    execute(run)
    line = result(run)
    card = f"{line['device']['kind']}, {line['device'].get('power_limit')}"
    print(f"[benchmark] {run.name} seed {run.seed}: {line['attempted']} frames in "
          f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s, check {run.check_s:.3f} s, "
          f"{card}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'OVER'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
