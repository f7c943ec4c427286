"""Demos 7-9 of the port (one frame each) on the CPU, each held to its JAX
twin: the port's ``main([...], --device cpu)`` in-process against ``python
demos/demoN_*.py ... --backend jnp`` in a subprocess, at 64x32, 1-2 spp
and 2-3 bounces, within compare()'s bounds (``test_torch_demos.py``)."""

import numpy as np
import pytest

from csgrenderer_tpu_torch.io.obj import write_obj
from test_torch_demos import SMALL, assert_png_close, run_jax, run_port

MESH = (*SMALL, "--spp", "1", "--bounces", "2")
NIGHT = (*SMALL, "--spp", "2", "--bounces", "3")
CASES = {  # the port's options; the JAX twin takes the same ones
    "demo7": ("demo7_mesh", MESH),
    "demo7-nee": ("demo7_mesh", (*MESH, "--nee")),
    "demo7-subdiv1": ("demo7_mesh", (*MESH, "--subdiv", "1")),  # 242 faces
    "demo7-obj": ("demo7_mesh", (*MESH, "--obj", "{obj}")),
    "demo8": ("demo8_night", NIGHT),
    "demo8-no-nee": ("demo8_night", (*NIGHT, "--no-nee")),
    "demo9": ("demo9_csg_night", NIGHT),
    "demo9-no-nee": ("demo9_csg_night", (*NIGHT, "--no-nee")),
}


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A directory for the JAX PNGs and a small OBJ (an octahedron over a
    floor quad, written with the port's ``write_obj``)."""
    root = tmp_path_factory.mktemp("jax_single")
    verts = np.array([[0, 1.6, -3], [0, 0.2, -3], [-0.7, 0.9, -3], [0.7, 0.9, -3],
                      [0, 0.9, -3.7], [0, 0.9, -2.3],
                      [-4, 0, -7], [4, 0, -7], [4, 0, 1], [-4, 0, 1]], np.float64)
    faces = np.array([[0, 2, 5], [0, 5, 3], [0, 3, 4], [0, 4, 2],
                      [1, 5, 2], [1, 3, 5], [1, 4, 3], [1, 2, 4],
                      [6, 7, 8], [6, 8, 9]], np.int64)
    write_obj(root / "octa.obj", verts, faces)
    return root


@pytest.mark.parametrize("case", list(CASES))
def test_demo_matches_its_jax_twin(case, shared, tmp_path, capsys):
    demo, opts = CASES[case]
    opts = tuple(o.format(obj=shared / "octa.obj") for o in opts)
    want = shared / f"{case}.png"
    run_jax(demo, *opts, "--backend", "jnp", "--out", str(want))
    got = tmp_path / f"{case}.png"
    out = run_port(capsys, demo, *opts, "--out", str(got))
    assert f"-> {got}" in out and "Mrays/s (render only)" in out
    assert_png_close(got, want)


def test_demo7_worklist_off_is_brute_force(shared, tmp_path, capsys):
    """``--worklist off`` renders through the mesh kernel's brute mode (the
    JAX demo's jnp path is brute force whatever the option)."""
    want = shared / "demo7-off.png"
    run_jax("demo7_mesh", *MESH, "--worklist", "off", "--backend", "jnp", "--out", str(want))
    got = tmp_path / "off.png"
    out = run_port(capsys, "demo7_mesh", *MESH, "--worklist", "off", "--out", str(got))
    assert "trimesh_kernel[brute]" in out
    assert_png_close(got, want)
