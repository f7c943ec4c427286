"""Randomised interval algebra of the port against a set-membership oracle
(the mirror of tests/test_interval_fuzz.py), and against the JAX
package's combine on the same random lists.

For random sorted, disjoint interval lists A and B and many probe points
t, membership in ``render/interval.combine(A, B, op)`` must equal op(t in
A, t in B); results must be sorted and disjoint; nested combines must
follow the formula; and on equal inputs the port's lists must equal the
JAX package's exactly (the combine sorts and compacts the same events).
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.render import interval
from csgrenderer_tpu_torch.render.intersect import T_FAR

# no case can exceed the cap (a union of 4 + 4 spans <= 8; the nested test
# uses at most 2 spans a list, so (A u B) \ C <= 6)
K = 8
OPS = {"union": lambda a, b: a or b, "intersect": lambda a, b: a and b,
       "diff": lambda a, b: a and not b}


def random_list(rng, max_n=4, domain=(0.0, 100.0)):
    """Sorted disjoint intervals inside the domain."""
    n = rng.integers(0, max_n + 1)
    points = np.sort(rng.uniform(*domain, size=2 * n))
    return [(points[2 * i], points[2 * i + 1]) for i in range(n)]


def to_arrays(lst):
    pad = [float(T_FAR)] * (K - len(lst))
    return (torch.tensor([[a for a, _ in lst] + pad], dtype=torch.float32),
            torch.tensor([[b for _, b in lst] + pad], dtype=torch.float32))


def member(lst, t):
    return any(a <= t < b for a, b in lst)


def spans(r_in, r_out):
    return [(i, o) for i, o in zip(r_in[0].tolist(), r_out[0].tolist()) if i < T_FAR / 2]


def op_seed(op):
    return sum(op.encode()) * 7919


@pytest.mark.parametrize("op", list(OPS))
def test_combine_matches_membership_oracle(op):
    rng = np.random.default_rng(op_seed(op))
    for _ in range(60):
        A, B = random_list(rng), random_list(rng)
        result = spans(*interval.combine(to_arrays(A), to_arrays(B), op=op, k=K))
        # probe at random points and near every endpoint (where bugs live)
        probes = list(rng.uniform(0.0, 100.0, size=40))
        for a, b in A + B:
            probes += [a - 1e-3, a + 1e-3, b - 1e-3, b + 1e-3]
        for t in probes:
            if t < 0:
                continue
            assert member(result, t) == OPS[op](member(A, t), member(B, t)), \
                f"op={op} t={t} A={A} B={B} -> {result}"


def test_combine_result_sorted_and_disjoint():
    rng = np.random.default_rng(7)
    for _ in range(40):
        A, B = random_list(rng), random_list(rng)
        real = spans(*interval.union(to_arrays(A), to_arrays(B), k=K))
        for (i1, o1), (i2, o2) in zip(real, real[1:]):
            assert i1 <= o1 <= i2 <= o2  # ordered and non-overlapping


def test_nested_combines_match_oracle():
    # (A u B) \ C across random triples: the config-3 shape
    rng = np.random.default_rng(11)
    for _ in range(30):
        A, B, C = (random_list(rng, max_n=2) for _ in range(3))
        u = interval.union(to_arrays(A), to_arrays(B), k=K)
        result = spans(*interval.difference(u, to_arrays(C), k=K))
        for t in rng.uniform(0.0, 100.0, size=50):
            want = (member(A, t) or member(B, t)) and not member(C, t)
            assert member(result, t) == want


@pytest.mark.parametrize("op", list(OPS))
def test_combine_equals_jax_on_random_lists(op):
    """The port's combine and the JAX package's give the same lists, bit for
    bit, on the same random inputs (single and nested)."""
    import jax.numpy as jnp

    from csgrenderer_tpu.render import interval as jiv

    def jax_arrays(x):
        return tuple(jnp.asarray(a.numpy()) for a in x)

    rng = np.random.default_rng(op_seed(op) + 1)
    for _ in range(40):
        A, B, C = (to_arrays(random_list(rng, max_n=3)) for _ in range(3))
        got = interval.combine(interval.combine(A, B, op=op, k=K), C, op=op, k=K)
        ja, jb, jc = (jax_arrays(x) for x in (A, B, C))
        want = jiv.combine(jiv.combine(ja, jb, op=op, k=K), jc, op=op, k=K)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
