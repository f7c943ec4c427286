"""Randomised CSG trees through the port's tape evaluator against a
point-membership oracle (the mirror of tests/test_tape_fuzz.py), and the
port's interval lists against the JAX package's on the same trees.

A random tree has random primitive leaves under random rigid edges and
random boolean ops. Along random rays, the root interval list of
``render/tape_eval.eval_tape_intervals`` must contain a sample point
exactly when the boolean formula over per-primitive membership (evaluated
in float64, the edge rotation in float32 as the tape's) holds, away from
surfaces (1e-3): the whole chain of transform composition, primitive
intervals and event combines. The JAX parity test builds each tree with
the same leaves, edges and ops in both packages and holds the lists to
each other. The tree builder imports no JAX: ``tests/test_torch_cuda.py``
renders the same trees through the tape kernel.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.math import quaternion as quat
from csgrenderer_tpu_torch.render.intersect import T_FAR
from csgrenderer_tpu_torch.render.tape_eval import eval_tape_intervals
from csgrenderer_tpu_torch.scene import NodeArgument, SceneGraph

K = 8
SEEDS = (0, 1, 2, 3)


def random_spec(rng, n_leaves=3):
    """A random tree as plain data: ``leaves`` [(kind, params)], then
    ``joins`` [(op, (q_a, off_a), (q_b, off_b))], each joining the last two
    nodes of the stack (the order of tests/test_tape_fuzz.py's builder)."""
    leaves = []
    for _ in range(n_leaves):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            leaves.append((0, (float(rng.uniform(0.3, 1.5)),)))
        elif kind == 1:
            n = rng.normal(size=3)
            leaves.append((1, tuple(n / np.linalg.norm(n))))
        elif kind == 2:
            leaves.append((2, tuple(rng.uniform(0.3, 1.2, size=3))))
        else:
            leaves.append((3, (float(rng.uniform(0.3, 1.0)), float(rng.uniform(0.3, 1.5)))))

    def edge():
        axis = torch.tensor(rng.normal(size=3), dtype=torch.float32)
        q = quat.from_axis_angle(axis, float(rng.uniform(0, 2 * np.pi)))
        return tuple(q.tolist()), tuple(rng.uniform(-1.5, 1.5, size=3))

    joins = []
    for _ in range(n_leaves - 1):
        ea, eb = edge(), edge()
        joins.append((int(rng.integers(0, 3)), ea, eb))
    return leaves, joins


def build_graph(spec, graph, node_argument):
    """The spec's tree in ``graph`` (either package's SceneGraph, with its
    NodeArgument); returns the root."""
    leaves, joins = spec
    add = {0: lambda p: graph.add_sphere_node(p[0]),
           1: graph.add_infinite_planar_partition_node,
           2: graph.add_box_node,
           3: lambda p: graph.add_cylinder_node(p[0], p[1])}
    stack = [add[kind](params) for kind, params in leaves]
    ops = (graph.add_union_of_node, graph.add_intersection_of_node,
           graph.add_difference_of_node)
    for op, (qa, oa), (qb, ob) in joins:
        na, nb = stack.pop(), stack.pop()
        stack.append(ops[op](node_argument(na, orientation=qa, offset=oa),
                             node_argument(nb, orientation=qb, offset=ob)))
    return stack[0]


def membership(spec):
    """The spec's solid as a function p (float64 [3]) -> bool."""
    leaves, joins = spec

    def leaf(kind, p):
        if kind == 0:
            return lambda x, r=p[0]: float(np.dot(x, x)) <= r * r
        if kind == 1:
            return lambda x, n=np.asarray(p): float(np.dot(x, n)) <= 0.0
        if kind == 2:
            return lambda x, he=np.asarray(p): bool(np.all(np.abs(x) <= he))
        return lambda x, r=p[0], h=p[1]: x[0] ** 2 + x[2] ** 2 <= r * r and abs(x[1]) <= h

    def placed(member, q, off):
        # p_parent = R(q) p_child + off  =>  p_child = R(q)^-1 (p_parent - off)
        qi = torch.tensor([q[0], -q[1], -q[2], -q[3]], dtype=torch.float32)
        off = np.asarray(off)

        def m(x):
            local = quat.rotate(qi, torch.tensor(x - off, dtype=torch.float32))
            return member(local.numpy().astype(np.float64))
        return m

    stack = [leaf(kind, p) for kind, p in leaves]
    for op, (qa, oa), (qb, ob) in joins:
        a, b = placed(stack.pop(), qa, oa), placed(stack.pop(), qb, ob)
        stack.append((lambda x, A=a, B=b: A(x) or B(x),
                      lambda x, A=a, B=b: A(x) and B(x),
                      lambda x, A=a, B=b: A(x) and not B(x))[op])
    return stack[0]


def random_rays(rng, n_rays=16):
    o = rng.uniform(-4, 4, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def port_tree(seed):
    """(spec, the port's compiled tape, rays, rng after them) of a seed."""
    rng = np.random.default_rng(seed)
    spec = random_spec(rng)
    g = SceneGraph(max_node_count=64)
    tape = g.compile(build_graph(spec, g, NodeArgument), k=K)
    o, d = random_rays(rng)
    return spec, tape, o, d, rng


@pytest.mark.parametrize("seed", SEEDS)
def test_random_tree_membership(seed):
    spec, tape, o, d, rng = port_tree(seed)
    member = membership(spec)
    t_in, t_out = (x.numpy() for x in eval_tape_intervals(tape, torch.from_numpy(o),
                                                          torch.from_numpy(d)))
    for i in range(len(o)):
        spans = [(a, b) for a, b in zip(t_in[i], t_out[i]) if a < T_FAR / 2]
        for t in rng.uniform(0.05, 8.0, size=12):
            p = o[i] + t * d[i]
            # f32 tape vs f64 oracle legitimately disagree on surfaces
            if min((min(abs(t - a), abs(t - b)) for a, b in spans), default=1.0) < 1e-3:
                continue
            got = any(a <= t < b for a, b in spans)
            want = member(p.astype(np.float64))
            assert got == want, f"seed={seed} ray={i} t={t} p={p} spans={spans}"


@pytest.mark.parametrize("seed", SEEDS)
def test_random_tree_lists_match_jax(seed):
    """The port's root interval lists equal the JAX package's on the same
    tree and rays: the same empty slots, and every real endpoint within
    1e-5 (the two packages bake the leaf transforms in float32 apart)."""
    import jax.numpy as jnp

    from csgrenderer_tpu.render.tape_eval import eval_tape_intervals as j_eval
    from csgrenderer_tpu.scene import NodeArgument as JNodeArgument
    from csgrenderer_tpu.scene import SceneGraph as JSceneGraph

    spec, tape, o, d, _ = port_tree(seed)
    jg = JSceneGraph(max_node_count=64)
    j_tape = jg.compile(build_graph(spec, jg, JNodeArgument), k=K)
    assert j_tape.ops == tape.ops and j_tape.leaf_chains == tape.leaf_chains
    got = [x.numpy() for x in eval_tape_intervals(tape, torch.from_numpy(o), torch.from_numpy(d))]
    want = [np.asarray(x) for x in j_eval(j_tape, jnp.asarray(o), jnp.asarray(d))]
    for g, w in zip(got, want):
        real = w < T_FAR / 2
        assert np.array_equal(g < T_FAR / 2, real)
        np.testing.assert_allclose(g[real], w[real], rtol=0, atol=1e-5)
