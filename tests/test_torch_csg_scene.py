"""The port's CSG scene layer against its JAX twin: quaternions, the scene
graph, the tape compiler, the CSG scene builders and the disjoint-cluster
decomposition.

Tolerances: static tape parts (ops, leaf types, chains, k, stack depth)
and partitions are identical; tape arrays agree to 1e-6 abs (float32
quaternion composition in another framework); quaternion ops agree to
1e-6 abs on 1024 random inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.math import quaternion as jquat
from csgrenderer_tpu.models import animated_csg_scene as j_anim
from csgrenderer_tpu.models import config3_csg_scene as j_c3
from csgrenderer_tpu.models import many_objects_scene as j_many
from csgrenderer_tpu.models import milestone01_scene_graph as j_m01
from csgrenderer_tpu.scene.partition import partition_tape as j_partition
from csgrenderer_tpu_torch.convert import tape_from_numpy
from csgrenderer_tpu_torch.math import quaternion as tquat
from csgrenderer_tpu_torch.models import (
    animated_csg_scene,
    config3_csg_scene,
    many_objects_scene,
    milestone01_scene_graph,
)
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph, partition_tape

STATIC = ("ops", "leaf_types", "leaf_chains", "k", "stack_depth")
ARRAYS = ("leaf_params", "edge_quat", "edge_off", "leaf_rot", "leaf_pos", "mat_kind", "albedo",
          "mat_param")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def port_tape(jt):
    """The JAX tape carried across as it is."""
    return tape_from_numpy(*(getattr(jt, f) for f in STATIC), *(np.asarray(getattr(jt, f)) for f in ARRAYS))


def _deep(t):
    g, animate = animated_csg_scene(8)
    return animate(g.compile(k=4), t)


def _j_deep(t):
    g, animate = j_anim(8)
    return animate(g.compile(k=4), t)


TAPES = {
    "config3": (lambda: config3_csg_scene().compile(), lambda: j_c3().compile()),
    "deepcsg-t0": (lambda: _deep(0.0), lambda: _j_deep(0.0)),
    "deepcsg-t1": (lambda: _deep(1.0), lambda: _j_deep(1.0)),
    "many-objects": (lambda: many_objects_scene().compile(), lambda: j_many().compile()),
    "milestone01": (lambda: milestone01_scene_graph().compile(k=2),
                    lambda: j_m01().compile(k=2)),
}


@pytest.mark.parametrize("name", sorted(TAPES))
def test_compiled_tape_matches_jax(name):
    port, ref = (f() for f in TAPES[name])
    for f in STATIC:
        assert getattr(port, f) == getattr(ref, f), f
    for f in ARRAYS:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)


def test_graph_tables_match_jax():
    for port, ref in ((config3_csg_scene(), j_c3()), (many_objects_scene(9), j_many(9)),
                      (milestone01_scene_graph(), j_m01())):
        assert port.node_type == ref.node_type
        assert [tuple(i) if isinstance(i, tuple) else i for i in port.node_info] == \
            [tuple(i) if isinstance(i, tuple) else i for i in ref.node_info]
        assert [tuple(m) for m in port.material] == [tuple(m) for m in ref.material]
        assert port.roots() == ref.roots()


def test_tape_from_numpy_is_the_jax_tape_exactly():
    ref = _j_deep(1.0)
    port = port_tape(ref)
    for f in STATIC:
        assert getattr(port, f) == getattr(ref, f)
    for f in ARRAYS:
        assert getattr(port, f).numpy().tobytes() == np.asarray(getattr(ref, f)).tobytes(), f


def test_rebake_and_with_edges_match_jax():
    ref = j_many(9).compile(k=4)
    port = port_tape(ref)
    rng = np.random.default_rng(3)
    q = rng.normal(size=np.asarray(ref.edge_quat).shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    off = rng.uniform(-2, 2, np.asarray(ref.edge_off).shape).astype(np.float32)
    got = port.with_edges(_t(q), _t(off))
    want = ref.with_edges(jnp.asarray(q), jnp.asarray(off))
    for f in ("leaf_rot", "leaf_pos"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-5, err_msg=f)


def test_tape_to_device_keeps_static_parts():
    tape = config3_csg_scene().compile(k=2)
    moved = tape.to("cpu")
    assert moved.ops == tape.ops and moved.leaf_chains == tape.leaf_chains
    assert moved.device.type == "cpu" and moved.n_leaves == 3


@pytest.fixture
def quat_inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1024, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    r = rng.normal(size=(1024, 4)).astype(np.float32)
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    v = rng.normal(size=(1024, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True) * rng.random((1024, 1))).astype(np.float32)
    axis = rng.normal(size=(1024, 3)).astype(np.float32)
    angle = rng.uniform(-4, 4, 1024).astype(np.float32)
    return q, r, v, axis, angle


@pytest.mark.parametrize("name", ["rotate", "rotate_inverse", "multiply", "from_axis_angle",
                                  "conjugate", "normalize", "to_rotation_matrix"])
def test_quaternion_matches_jax(quat_inputs, name):
    q, r, v, axis, angle = quat_inputs
    args = {"rotate": (q, v), "rotate_inverse": (q, v), "multiply": (q, r),
            "from_axis_angle": (axis, angle), "conjugate": (r * 2.0,),
            "normalize": (r * 3.0,), "to_rotation_matrix": (q,)}[name]
    ref = getattr(jquat, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tquat, name)(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_quaternion_identity():
    np.testing.assert_array_equal(tquat.identity().numpy(), np.asarray(jquat.identity()))


PARTITIONS = {
    "deepcsg-t1": (lambda: _deep(1.0), lambda: _j_deep(1.0)),
    "many-objects": (lambda: many_objects_scene().compile(), lambda: j_many().compile()),
    "many-objects-99": (lambda: many_objects_scene(99).compile(k=4),
                        lambda: j_many(99).compile(k=4)),
    "config3": (lambda: config3_csg_scene().compile(k=2), lambda: j_c3().compile(k=2)),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_partition_matches_jax(name):
    port, ref = (f() for f in PARTITIONS[name])
    assert partition_tape(port) == j_partition(ref)
    # the JAX tape carried across clusters the same, too
    assert partition_tape(port_tape(ref)) == j_partition(ref)


def test_partition_sizes_of_the_slice_scenes():
    deep = partition_tape(_deep(1.0))
    assert len(deep) == 2 and max(len(c[1]) for c in deep) == 6
    assert partition_tape(_deep(1.0)) is not None and partition_tape(config3_csg_scene().compile()) is None
    many = partition_tape(many_objects_scene(99).compile(k=4))
    assert len(many) == 100 and sum(len(c[1]) ** 2 for c in many) == 397
    leaves = sorted(leaf for c in many for leaf in c[1])
    assert leaves == list(range(199))


def _partition_case(name):
    g = SceneGraph(max_node_count=16)
    lam = Material.lambertian((0.5, 0.5, 0.5))
    if name == "overlapping":
        a, b = g.add_sphere_node(1.0, lam), g.add_sphere_node(1.0, lam)
        g.add_union_of_node(NA(a), NA(b, offset=(1.0, 0, 0)))
        return g, None
    if name == "disjoint":
        a, b = g.add_sphere_node(0.5, lam), g.add_sphere_node(0.5, lam)
        c = g.add_box_node((0.4, 0.4, 0.4), lam)
        u = g.add_union_of_node(NA(a, offset=(-3, 0.5, 0)), NA(b, offset=(3, 0.5, 0)))
        g.add_union_of_node(NA(u), NA(c, offset=(0, 0.4, 5)))
        return g, [1, 1, 1]
    gr = g.add_infinite_planar_partition_node((0, 1, 0), lam)
    if name == "resting-and-sunk":
        resting, sunk = g.add_sphere_node(0.5, lam), g.add_sphere_node(0.5, lam)
        u = g.add_union_of_node(NA(resting, offset=(-3, 0.5, 0)), NA(sunk, offset=(3, 0.2, 0)))
        g.add_union_of_node(NA(u), NA(gr))
        return g, [1, 2]
    mat = Material.dielectric(1.5) if name == "glass-contact" else Material.lambertian((0.3, 0.3, 0.6))
    c = g.add_cylinder_node(0.5, 0.6, mat)  # cap at y = 0 exactly
    far = g.add_sphere_node(0.5, lam)
    u = g.add_union_of_node(NA(c, offset=(0, 0.6, 0)), NA(far, offset=(4, 0.5, 0)))
    g.add_union_of_node(NA(u), NA(gr))
    return g, [1, 2] if name == "glass-contact" else [1, 1, 1]


@pytest.mark.parametrize("name", ["overlapping", "disjoint", "resting-and-sunk", "glass-contact",
                                  "opaque-contact"])
def test_partition_decisions(name):
    """The clustering rules (tests/test_partition.py), on the port's copy."""
    g, sizes = _partition_case(name)
    cl = partition_tape(g.compile(k=2))
    if sizes is None:
        assert cl is None
    else:
        assert sorted(len(c[1]) for c in cl) == sizes
