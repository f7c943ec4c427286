"""Import purity of the PyTorch/CUDA port.

The port must run on a host without JAX and must not touch the GPU or
Triton just by being imported (the CPU tests import every module).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "csgrenderer_tpu_torch"

MODULES = [
    "csgrenderer_tpu_torch",
    "csgrenderer_tpu_torch.math",
    "csgrenderer_tpu_torch.math.quaternion",
    "csgrenderer_tpu_torch.camera",
    "csgrenderer_tpu_torch.scene",
    "csgrenderer_tpu_torch.scene.graph",
    "csgrenderer_tpu_torch.scene.tape",
    "csgrenderer_tpu_torch.scene.partition",
    "csgrenderer_tpu_torch.render",
    "csgrenderer_tpu_torch.render.interval",
    "csgrenderer_tpu_torch.render.tape_eval",
    "csgrenderer_tpu_torch.render.trimesh",
    "csgrenderer_tpu_torch.models",
    "csgrenderer_tpu_torch.kernels",
    "csgrenderer_tpu_torch.kernels.build",
    "csgrenderer_tpu_torch.kernels.tape_kernel",
    "csgrenderer_tpu_torch.kernels.tri_worklist",
    "csgrenderer_tpu_torch.kernels.trimesh_kernel",
    "csgrenderer_tpu_torch.io",
    "csgrenderer_tpu_torch.io.obj",
    "csgrenderer_tpu_torch.convert",
    "csgrenderer_tpu_torch.bench",
    "csgrenderer_tpu_torch.__main__",
]


def test_import_touches_no_jax_triton_or_cuda():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import torch\n"
        "bad = [m for m in ('jax', 'ml_dtypes', 'triton', 'csgrenderer_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clean" in proc.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|ml_dtypes|triton|csgrenderer_tpu)(\.|\s|$)", re.MULTILINE
)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    """No module of the port imports jax, ml_dtypes, triton (only inside a
    launching function would be allowed) or the JAX package."""
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_chip_smoke_imports_no_jax():
    assert not _FORBIDDEN.findall((REPO / "chip_smoke.py").read_text())
