"""The port's CLI and benchmark entry points, run as a user runs them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.io import read_png

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_render_writes_png(tmp_path):
    out = tmp_path / "rtiow.png"
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", "rtiow", "--width", "32",
                "--height", "18", "--spp", "1", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = read_png(out)
    assert img.shape == (18, 32, 3) and img.dtype == np.uint8
    assert img.std() > 0  # not a blank frame


def test_render_unported_scene_says_so(tmp_path):
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", "csg", "--out",
                str(tmp_path / "x.png"))
    assert proc.returncode != 0
    assert "not yet ported" in proc.stderr


def test_bench_quick_prints_one_json_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the benchmark would measure it")
    proc = _run("csgrenderer_tpu_torch.bench", "--quick", "--frames", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    for key in ("metric", "value", "p50_frame_ms_16spp", "rays", "backend", "platform",
                "frames", "frame_times_s", "value_mean", "config", "device_name", "power_limit"):
        assert key in res, key
    assert res["platform"] == "cpu" and res["backend"] == "torch-plain"
    assert isinstance(res["rays"], int) and res["rays"] >= 320 * 180 * 4
    assert len(res["frame_times_s"]) == 1


def test_bench_refuses_to_measure_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the benchmark would measure it")
    proc = _run("csgrenderer_tpu_torch.bench", "--quick", "--frames", "1", "--device", "cuda")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
