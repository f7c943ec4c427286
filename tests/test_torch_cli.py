"""The port's CLI and benchmark entry points, run as a user runs them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.io import read_png, rmse

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs in several workers at once
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
    """Every scene and option of the JAX CLI is ported, the denoise step
    too: nothing says "not ported". As in the JAX CLI, ``--denoise``
    leaves milestone01, the reference shader's frame, unfiltered."""
    out = tmp_path / "x.png"
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", "milestone01", "--denoise",
                "--width", "320", "--height", "240", "--time", "0.25", "--device", "cpu",
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "not ported" not in proc.stdout + proc.stderr
    golden = read_png(REPO / "tests" / "goldens" / "config1_milestone01.png")
    assert rmse(read_png(out), golden) <= 1e-3


def test_render_denoise(tmp_path):
    """``render --denoise --denoise-iters 2``: the denoised frame differs
    from the raw one and is smoother (less pixel-to-pixel variation)."""
    outs = {}
    for label, extra in (("raw", ()), ("den", ("--denoise", "--denoise-iters", "2"))):
        outs[label] = tmp_path / f"{label}.png"
        proc = _run("csgrenderer_tpu_torch", "render", "--scene", "rtiow", "--width", "32",
                    "--height", "18", "--spp", "1", "--device", "cpu", *extra,
                    "--out", str(outs[label]))
        assert proc.returncode == 0, proc.stderr[-2000:]
    raw, den = (read_png(outs[k]).astype(float) for k in ("raw", "den"))
    assert den.shape == (18, 32, 3) and not np.array_equal(raw, den)
    assert np.abs(np.diff(den, axis=1)).mean() < np.abs(np.diff(raw, axis=1)).mean()


def test_render_milestone01(tmp_path):
    """The reference shader's frame through WololoRenderer, as the JAX CLI
    renders it (tools/make_goldens.py config1 at its size and time)."""
    out = tmp_path / "m.png"
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", "milestone01", "--width", "320",
                "--height", "240", "--time", "0.25", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    golden = read_png(REPO / "tests" / "goldens" / "config1_milestone01.png")
    assert rmse(read_png(out), golden) <= 1e-3


def test_render_target_noise(tmp_path):
    out = tmp_path / "d.png"
    proc = _run("csgrenderer_tpu_torch", "render", "--scene", "diffuse", "--width", "32",
                "--height", "16", "--spp", "4", "--bounces", "3", "--target-noise", "5e-2",
                "--max-spp", "64", "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = next(l for l in proc.stdout.splitlines() if "render-to-noise" in l)
    used = int(line.split(":")[1].split("spp")[0])
    noise = float(line.split("measured noise")[1].split()[0])
    assert used % 8 == 0 and 0 < used <= 64 and noise <= 5e-2
    assert read_png(out).shape == (16, 32, 3)


def test_gif_deepcsg_frames(tmp_path):
    """config 5 animated, its tape reclustered every frame: two GIF frames
    that differ (the chain moves)."""
    out = tmp_path / "d.gif"
    proc = _run("csgrenderer_tpu_torch", "gif", "--scene", "deepcsg", "--frames", "2", "--fps",
                "2", "--width", "32", "--height", "24", "--spp", "1", "--bounces", "2",
                "--device", "cpu", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-2000:]
    data = out.read_bytes()
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    assert data.count(b"\x21\xf9\x04") == 2  # one graphic control block per frame
    assert "2 frames" in proc.stdout


def test_info_names_device_scenes_and_kernels():
    proc = _run("csgrenderer_tpu_torch", "info")
    assert proc.returncode == 0, proc.stderr[-2000:]
    for word in ("device:", "milestone01", "meshnight", "tape_kernel", "trimesh_kernel",
                 "native scene core: "):
        assert word in proc.stdout, word
    # the port's own build of native/scene_core.cpp, or why there is none
    core = next(l for l in proc.stdout.splitlines() if l.startswith("native scene core: "))
    assert "kernels/_build/libcsgr_scene-" in core or "unavailable (" in core, core


def test_bench_quick_prints_one_json_line():
    proc = _run("csgrenderer_tpu_torch.bench", "--quick", "--frames", "1", "--device", "cpu")
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


@pytest.mark.parametrize("command", [("csgrenderer_tpu_torch.bench", "--quick", "--frames", "1"),
                                     ("csgrenderer_tpu_torch", "render", "--scene", "diffuse",
                                      "--width", "8", "--height", "4", "--spp", "1")])
def test_no_device_means_the_gpu(tmp_path, command):
    """Without --device the entry points run on the GPU: where there is none
    they exit non-zero and name --device cpu, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run on it")
    args = command + (("--out", str(tmp_path / "x.png")) if "render" in command else ())
    proc = _run(*args)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("args", [
    ("--scene", "rtiow", "--denoise", "--serve", "0", "--gif", "{tmp}/d6.gif"),
    ("--scene", "night", "--target-noise", "0.05", "--readback", "full"),
    ("--scene", "wololo", "--frames-in-flight", "1"),
], ids=["rtiow-denoise-serve", "night-adaptive", "wololo"])
def test_demo6_realtime_on_the_cpu(tmp_path, args):
    """The demo 6 twin at 32x18 for 0.5 s on the CPU exits 0 and reports
    its frame rate (the preview server on a free port)."""
    args = [a.format(tmp=tmp_path) for a in args]
    proc = _run("csgrenderer_tpu_torch.demos.demo6_realtime", "--device", "cpu", "--width", "32",
                "--height", "18", "--seconds", "0.5", "--spp", "1", "--bounces", "2", *args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fps sustained at 32x18" in proc.stdout
    if "--serve" in args:
        assert "live preview at http://127.0.0.1:" in proc.stdout
        assert (tmp_path / "d6.gif").read_bytes()[:6] == b"GIF89a"


def test_demo6_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("csgrenderer_tpu_torch.demos.demo6_realtime", "--seconds", "0.1")
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
