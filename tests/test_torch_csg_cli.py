"""The port's CLI and benchmark on the CSG scenes, run as a user runs them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from csgrenderer_tpu_torch.io import read_png

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs in several workers at once
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("scene", ["csg", "manyobjects"])
def test_render_csg_writes_png(tmp_path, scene):
    out = tmp_path / f"{scene}.png"
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", scene, "--width", "32",
                "--height", "24", "--spp", "1", "--bounces", "3", "--device", "cpu",
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = read_png(out)
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    assert img.std() > 0


def test_bench_quick_deepcsg_prints_one_json_line():
    proc = _run("csgrenderer_tpu_torch.bench", "--quick", "--frames", "1", "--scene", "deepcsg",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["scene"] == "deepcsg" and res["backend"] == "torch-plain"
    assert "config5-deepcsg-t1 320x180 spp=4 bounces=5 mode=clustered" == res["config"]
    assert res["rays"] >= 320 * 180 * 4
