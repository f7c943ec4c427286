"""Import purity of the PyTorch/CUDA port.

The port must run on a host without JAX and must not touch the GPU or
Triton, or start a process group, just by being imported (the CPU tests
import every module).
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
    "csgrenderer_tpu_torch.scene.native",
    "csgrenderer_tpu_torch.render",
    "csgrenderer_tpu_torch.render.interval",
    "csgrenderer_tpu_torch.render.tape_eval",
    "csgrenderer_tpu_torch.render.trimesh",
    "csgrenderer_tpu_torch.render.aov",
    "csgrenderer_tpu_torch.render.denoise",
    "csgrenderer_tpu_torch.models",
    "csgrenderer_tpu_torch.kernels",
    "csgrenderer_tpu_torch.kernels.build",
    "csgrenderer_tpu_torch.kernels.tape_kernel",
    "csgrenderer_tpu_torch.kernels.tri_worklist",
    "csgrenderer_tpu_torch.kernels.trimesh_kernel",
    "csgrenderer_tpu_torch.kernels.shard_canary",
    "csgrenderer_tpu_torch.kernels.atrous",
    "csgrenderer_tpu_torch.io",
    "csgrenderer_tpu_torch.io.obj",
    "csgrenderer_tpu_torch.io.checkpoint",
    "csgrenderer_tpu_torch.io.video",
    "csgrenderer_tpu_torch.camera.pinhole",
    "csgrenderer_tpu_torch.render.integrator",
    "csgrenderer_tpu_torch.utils",
    "csgrenderer_tpu_torch.utils.config",
    "csgrenderer_tpu_torch.utils.logging",
    "csgrenderer_tpu_torch.utils.profiling",
    "csgrenderer_tpu_torch.app",
    "csgrenderer_tpu_torch.app.stats",
    "csgrenderer_tpu_torch.app.loop",
    "csgrenderer_tpu_torch.app.renderers",
    "csgrenderer_tpu_torch.app.frame_graph",
    "csgrenderer_tpu_torch.app.goldens",
    "csgrenderer_tpu_torch.app.adaptive",
    "csgrenderer_tpu_torch.app.preview",
    "csgrenderer_tpu_torch.app.controls",
    "csgrenderer_tpu_torch.demos",
    "csgrenderer_tpu_torch.demos._common",
    "csgrenderer_tpu_torch.demos.demo1_sphere_normals",
    "csgrenderer_tpu_torch.demos.demo2_diffuse_spheres",
    "csgrenderer_tpu_torch.demos.demo3_csg_boolean",
    "csgrenderer_tpu_torch.demos.demo4_rtiow_final",
    "csgrenderer_tpu_torch.demos.demo5_animated_csg",
    "csgrenderer_tpu_torch.demos.demo6_realtime",
    "csgrenderer_tpu_torch.demos.demo7_mesh",
    "csgrenderer_tpu_torch.demos.demo8_night",
    "csgrenderer_tpu_torch.demos.demo9_csg_night",
    "csgrenderer_tpu_torch.convert",
    "csgrenderer_tpu_torch.bench",
    "csgrenderer_tpu_torch.__main__",
    "csgrenderer_tpu_torch.tools",
    "csgrenderer_tpu_torch.tools.common",
    "csgrenderer_tpu_torch.tools.exp_gather",
    "csgrenderer_tpu_torch.tools.exp_slab",
    "csgrenderer_tpu_torch.tools.exp_dot_k",
    "csgrenderer_tpu_torch.tools.validate_gpu",
    "csgrenderer_tpu_torch.tools.shadow_walk_probe",
    "csgrenderer_tpu_torch.parallel",
    "csgrenderer_tpu_torch.parallel.mesh",
    "csgrenderer_tpu_torch.parallel.shard",
    "csgrenderer_tpu_torch.parallel.launch",
]


def test_import_touches_no_jax_triton_or_cuda():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import torch\n"
        "bad = [m for m in ('jax', 'ml_dtypes', 'triton', 'csgrenderer_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
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


# JAX-only or TPU-only names that the port leaves out (ROADMAP, "Not to port")
NOT_TO_PORT = {
    "kernels": {"render_image_pallas", "render_image_tape_pallas", "render_image_mesh_pallas"},
    "utils": {"enable_debug_mode", "disable_debug_mode"},
}
SUBPACKAGES = ("app", "camera", "io", "kernels", "math", "models", "parallel", "render", "scene",
               "utils")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_every_jax_name(sub):
    """Each sub-package's ``__all__`` holds every name of the JAX package's
    (minus those not to port), and each name resolves."""
    import importlib

    ref = importlib.import_module(f"csgrenderer_tpu.{sub}")
    got = importlib.import_module(f"csgrenderer_tpu_torch.{sub}")
    missing = set(ref.__all__) - set(got.__all__) - NOT_TO_PORT.get(sub, set())
    assert not missing, sorted(missing)
    assert all(hasattr(got, name) for name in got.__all__)
