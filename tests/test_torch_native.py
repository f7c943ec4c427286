"""The port's native C++ scene core: parity with the port's Python
SceneGraph tape for tape, and with the JAX package's NativeSceneGraph bit
for bit (the mirror of tests/test_native.py)."""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.math import quaternion as quat
from csgrenderer_tpu_torch.scene import Material, NodeArgument, SceneGraph
from csgrenderer_tpu_torch.scene import native

pytestmark = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="no C++ toolchain",
)

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("leaf_params", "leaf_rot", "leaf_pos", "mat_kind", "albedo", "mat_param", "edge_quat",
          "edge_off")


def build_both(builder):
    py = SceneGraph(max_node_count=64)
    nat = native.NativeSceneGraph(max_node_count=64)
    root_py = builder(py)
    root_nat = builder(nat)
    assert root_py == root_nat
    return py.compile(root_py), nat.compile(root_nat)


def assert_tapes_equal(a, b, atol=1e-6):
    assert a.ops == b.ops
    assert a.leaf_types == b.leaf_types
    assert a.leaf_chains == b.leaf_chains
    assert a.stack_depth == b.stack_depth
    for attr in FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr)),
                                   atol=atol, err_msg=attr)


# each builder takes the graph and its package's NodeArgument and Material
def build_union(g, NA=NodeArgument, M=Material):
    s1 = g.add_sphere_node(1.0, M.lambertian((0.8, 0.2, 0.2)))
    s2 = g.add_sphere_node(0.5, M.metal((0.9, 0.9, 0.9), 0.1))
    return g.add_union_of_node(NA(s1, offset=(-1, 0, 0)), NA(s2, offset=(1, 0, 0)))


def build_all_ops(g, NA=NodeArgument, M=Material):
    q = tuple(quat.from_axis_angle(torch.tensor([0.0, 1.0, 0.0]), 0.7).tolist())
    s = g.add_sphere_node(1.0)
    b = g.add_box_node((0.5, 0.6, 0.7), M.dielectric(1.5))
    c = g.add_cylinder_node(0.4, 1.2)
    h = g.add_infinite_planar_partition_node((0.0, 2.0, 0.0))
    u = g.add_union_of_node(NA(s, orientation=q), NA(b))
    i = g.add_intersection_of_node(NA(u, offset=(0, 1, 0)), NA(c))
    return g.add_difference_of_node(NA(i, orientation=q, offset=(1, 2, 3)), NA(h))


def build_csg(g, NA=NodeArgument, M=Material):
    s = g.add_sphere_node(1.0, M.lambertian((0.7, 0.3, 0.3)))
    b = g.add_box_node((0.8, 0.8, 0.8), M.lambertian((0.3, 0.7, 0.3)))
    c = g.add_cylinder_node(0.55, 1.6)
    u = g.add_union_of_node(NA(s, offset=(-0.3, 0, 0)), NA(b, offset=(0.5, 0, 0)))
    return g.add_difference_of_node(NA(u), NA(c))


def test_simple_union_parity():
    assert_tapes_equal(*build_both(build_union))


def test_all_primitives_and_ops_parity():
    assert_tapes_equal(*build_both(build_all_ops))


def test_root_bitset_parity():
    g = native.NativeSceneGraph(max_node_count=8)
    s1 = g.add_sphere_node(1.0)
    s2 = g.add_sphere_node(1.0)
    blob = g.add_union_of_node(NodeArgument(s1), NodeArgument(s2))
    assert not g.is_root(s1)
    assert not g.is_root(s2)
    assert g.is_root(blob)
    assert g.node_count == 3


def test_pool_exhaustion_parity():
    g = native.NativeSceneGraph(max_node_count=1)
    g.add_sphere_node(1.0)
    with pytest.raises(RuntimeError, match="exhausted"):
        g.add_sphere_node(1.0)


def test_bad_child_rejected():
    g = native.NativeSceneGraph(max_node_count=8)
    s = g.add_sphere_node(1.0)
    with pytest.raises(ValueError):
        g.add_union_of_node(NodeArgument(s), NodeArgument(99))


def test_native_tape_renders_identically():
    from csgrenderer_tpu_torch.render.tape_eval import tape_nearest_hit

    tape_py, tape_nat = build_both(build_csg)
    o = torch.tensor([[0.0, 0.2, -5.0], [1.0, 0.4, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.05, 1.0]])
    h1 = tape_nearest_hit(tape_py, o, d)
    h2 = tape_nearest_hit(tape_nat, o, d)
    np.testing.assert_allclose(h1.t.numpy(), h2.t.numpy(), atol=1e-5)
    np.testing.assert_allclose(h1.normal.numpy(), h2.normal.numpy(), atol=1e-5)


@pytest.mark.parametrize("builder", [build_union, build_all_ops, build_csg],
                         ids=["union", "all_ops", "csg"])
def test_native_tape_equals_jax_native_tape_bit_for_bit(builder):
    from csgrenderer_tpu import scene as jscene
    from csgrenderer_tpu.scene.native import NativeSceneGraph as JaxNative

    nat = native.NativeSceneGraph(max_node_count=64)
    ref = JaxNative(max_node_count=64)
    got = nat.compile(builder(nat))
    want = ref.compile(builder(ref, jscene.NodeArgument, jscene.Material))
    for attr in ("ops", "leaf_types", "leaf_chains", "k", "stack_depth"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in FIELDS:
        a, b = getattr(got, attr).numpy(), np.asarray(getattr(want, attr))
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert a.tobytes() == b.tobytes(), attr


def test_compiler_flags_are_the_makefiles():
    text = (REPO / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS\s*\?=\s*(.+)$", text, re.MULTILINE).group(1).split()
    assert tuple(flags) == native.CXXFLAGS
    assert native.SOURCE == REPO / "native" / "scene_core.cpp"


def test_library_is_built_under_the_ports_build_dir():
    from csgrenderer_tpu_torch.kernels import build

    path = native.ensure_built()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libcsgr_scene-") and path.suffix == ".so"
    assert (REPO / "native") not in path.parents
    assert native.ensure_built() == path  # the second call reuses it
