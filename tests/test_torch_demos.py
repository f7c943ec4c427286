"""Demos 1-5 of the port on the CPU, each held to its JAX twin.

Each port demo runs in-process through ``main([...])`` with ``--device
cpu`` (the kernels' plain versions) at 64x32, 1-2 spp and 2-3 bounces; its
JAX twin runs as ``python demos/demoN_*.py ... --cpu`` in a subprocess at
the same arguments. The two PNGs are held to the bounds of
``tests/test_kernels.py::compare`` on the [0, 1] scale: RMSE <= 2e-2 and
at most 1% of pixels off by more than 0.05 in any channel. Demos 7-9 are
in ``test_torch_demos_single.py``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.io import read_png

REPO = Path(__file__).resolve().parent.parent
SMALL = ("--width", "64", "--height", "32")
DEMOS = ("demo1_sphere_normals", "demo2_diffuse_spheres", "demo3_csg_boolean",
         "demo4_rtiow_final", "demo5_animated_csg", "demo7_mesh", "demo8_night",
         "demo9_csg_night")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs in several workers at once
    env["JAX_PLATFORMS"] = "cpu"
    return env


@functools.cache
def run_jax(script: str, *args: str) -> str:
    """``python demos/<script>.py *args`` (the JAX twin, on the CPU); its
    stdout. Cached: a test file's tests share one run of each command."""
    proc = subprocess.run([sys.executable, str(REPO / "demos" / f"{script}.py"), *args],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def run_port(capsys, demo: str, *args: str) -> str:
    """The port's demo in this process on the CPU; its stdout."""
    import importlib

    mod = importlib.import_module(f"csgrenderer_tpu_torch.demos.{demo}")
    capsys.readouterr()
    rc = mod.main([*args, "--device", "cpu"])
    assert rc in (None, 0)
    return capsys.readouterr().out


def assert_png_close(got_path, want_path):
    """compare()'s bounds on two uint8 PNGs scaled to [0, 1]; the image
    must not be constant."""
    got = read_png(got_path).astype(np.float64) / 255.0
    want = read_png(want_path).astype(np.float64) / 255.0
    assert got.shape == want.shape
    assert got.std() > 0, f"{got_path} is constant"
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    bad = float((np.abs(got - want).max(axis=-1) > 0.05).mean())
    assert rmse <= 2e-2, f"rmse {rmse}"
    assert bad <= 0.01, f"{bad:.3%} divergent pixels"


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_demos")


# (demo, options beyond SMALL, the PNG written into --out)
SEQUENCE_CASES = {
    "demo1": ("demo1_sphere_normals", (), "milestone01_0000.png"),
    "demo2": ("demo2_diffuse_spheres", ("--spp", "2", "--bounces", "3"), "diffuse_0000.png"),
    "demo3": ("demo3_csg_boolean", ("--spp", "2", "--bounces", "3"), "csg_0000.png"),
    "demo3-native": ("demo3_csg_boolean", ("--spp", "2", "--bounces", "3", "--native"),
                     "csg_0000.png"),
    "demo4": ("demo4_rtiow_final", ("--spp", "2", "--bounces", "3", "--frames", "2"),
              "rtiow_0001.png"),
    "demo5": ("demo5_animated_csg", ("--spp", "1", "--bounces", "2", "--frames", "2"),
              "deepcsg_0001.png"),
    "demo5-orbit": ("demo5_animated_csg",
                    ("--spp", "1", "--bounces", "2", "--frames", "2", "--orbit"),
                    "deepcsg_0001.png"),
    "demo5-target-noise": ("demo5_animated_csg",
                           ("--spp", "1", "--bounces", "2", "--target-noise", "0.1",
                            "--max-spp", "8"), "deepcsg_0000.png"),
}


def jax_sequence(jax_dir, case):
    demo, opts, png = SEQUENCE_CASES[case]
    out = jax_dir / case
    stdout = run_jax(demo, *SMALL, *opts, "--cpu", "--out", str(out))
    return out / png, stdout


@pytest.mark.parametrize("case", list(SEQUENCE_CASES))
def test_demo_matches_its_jax_twin(case, jax_dir, tmp_path, capsys):
    demo, opts, png = SEQUENCE_CASES[case]
    want, want_out = jax_sequence(jax_dir, case)
    got_out = run_port(capsys, demo, *SMALL, *opts, "--out", str(tmp_path))
    assert_png_close(tmp_path / png, want)
    if demo == "demo5_animated_csg" and "--orbit" not in opts:
        # the same accumulated samples and traced rays as the JAX demo
        line = next(l for l in want_out.splitlines() if "accumulated" in l)
        assert line in got_out


def test_demo1_prints_the_jax_root_flags(jax_dir, tmp_path, capsys):
    _, want_out = jax_sequence(jax_dir, "demo1")
    got_out = run_port(capsys, "demo1_sphere_normals", *SMALL, "--out", str(tmp_path))
    flags = [l for l in want_out.splitlines() if "is root" in l]
    assert flags == ["Sphere1 is root: 0", "Sphere2 is root: 0", "Blob is root: 1"]
    assert [l for l in got_out.splitlines() if "is root" in l] == flags


def test_demo3_native_equals_the_python_graph(tmp_path, capsys):
    opts = (*SMALL, "--spp", "2", "--bounces", "3")
    run_port(capsys, "demo3_csg_boolean", *opts, "--out", str(tmp_path / "py"))
    run_port(capsys, "demo3_csg_boolean", *opts, "--native", "--out", str(tmp_path / "native"))
    py = read_png(tmp_path / "py" / "csg_0000.png")
    assert py.std() > 0
    np.testing.assert_array_equal(read_png(tmp_path / "native" / "csg_0000.png"), py)


def _checkpoint(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


DEMO5 = (*SMALL, "--spp", "1", "--bounces", "2")


def test_demo5_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """2 frames, a checkpoint, 2 more resumed from it: the accumulator and
    the traced rays equal those of 4 uninterrupted frames, bit for bit."""
    a, b, c = (str(tmp_path / f"{n}.npz") for n in "abc")
    run_port(capsys, "demo5_animated_csg", *DEMO5, "--frames", "2", "--checkpoint", a,
             "--out", str(tmp_path / "a"))
    out = run_port(capsys, "demo5_animated_csg", *DEMO5, "--frames", "2", "--resume", a,
                   "--checkpoint", b, "--out", str(tmp_path / "b"))
    assert "resumed at 2 spp" in out and "accumulated 4 spp" in out
    run_port(capsys, "demo5_animated_csg", *DEMO5, "--frames", "4", "--checkpoint", c,
             "--out", str(tmp_path / "c"))
    resumed, straight = _checkpoint(b), _checkpoint(c)
    assert resumed.keys() == straight.keys()
    for k in straight:
        assert resumed[k].dtype == straight[k].dtype
        assert resumed[k].tobytes() == straight[k].tobytes(), k


def test_demo5_resumes_a_checkpoint_of_the_jax_demo(jax_dir, tmp_path, capsys):
    """The JAX demo's 2-frame checkpoint, resumed by the port for 1 frame,
    matches the port's own 3 frames within compare()'s bounds."""
    ck = str(jax_dir / "jax5.npz")
    run_jax("demo5_animated_csg", *DEMO5, "--frames", "2", "--cpu", "--checkpoint", ck,
            "--out", str(jax_dir / "jax5"))
    resumed, straight = str(tmp_path / "r.npz"), str(tmp_path / "s.npz")
    out = run_port(capsys, "demo5_animated_csg", *DEMO5, "--frames", "1", "--resume", ck,
                   "--checkpoint", resumed, "--out", str(tmp_path / "r"))
    assert "resumed at 2 spp" in out
    run_port(capsys, "demo5_animated_csg", *DEMO5, "--frames", "3", "--checkpoint", straight,
             "--out", str(tmp_path / "s"))
    got, want = _checkpoint(resumed), _checkpoint(straight)
    assert int(got["sample_count"]) == int(want["sample_count"]) == 3
    ref_rays = int(want["rays_traced"])
    assert abs(int(got["rays_traced"]) - ref_rays) <= max(ref_rays * 2e-3, 8)
    g, w = (x["radiance_sum"] / 3.0 for x in (got, want))
    assert float(np.sqrt(np.mean((g - w) ** 2))) <= 2e-2
    assert float((np.abs(g - w).max(axis=-1) > 0.05).mean()) <= 0.01


@pytest.mark.parametrize("demo", DEMOS)
def test_demo_refuses_cuda_without_it(demo):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", f"csgrenderer_tpu_torch.demos.{demo}", *SMALL],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
