"""A run end to end: its result line, its refusal without a card, and the
imports it pulls in."""

import json
import subprocess
import sys

import benchmark_cpu
import pytest

from benchmark import harness

REPO = benchmark_cpu.REPO


@pytest.mark.parametrize("cell", sorted(benchmark_cpu.TINY))
def test_the_result_line_has_its_keys(cell):
    run = benchmark_cpu.tiny_run(cell)
    line = json.loads(json.dumps(harness.result(run)))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == len(run.frames) >= 1
    assert line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    want = {m["name"] for m in harness.metrics_for(run.spec, cell, False)}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == set(run.cell["limits"])
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())


def test_a_measured_run_without_cuda_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "rtiow-offline-1080p64", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


IMPORTS = """
import sys, time, torch
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import benchmark.run, benchmark.control
import benchmark_cpu
for cell in benchmark_cpu.TINY:
    benchmark_cpu.tiny_run(cell, seconds=0.02)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "csgrenderer_tpu"))
print(bad)
"""


def test_nothing_a_run_imports_pulls_in_jax_or_the_jax_package():
    code = IMPORTS.format(repo=str(REPO), tests=str(REPO / "tests" / "benchmark"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
