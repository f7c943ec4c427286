"""The port's CSG reference evaluator against its JAX twin: leaf intervals
and normals, the interval-list algebra, the tape evaluator with its
attribution, and the hit adapter (the goldens are in
tests/test_torch_csg_goldens.py).

Tolerances: interval functions within 1 ulp on 4096 random local rays
(which include axis-parallel directions, rays parallel to the half-space
and origins inside each solid); interval-list combines exact on equal
inputs; ``tape_nearest_hit`` t within 1e-5 abs and hit / entering /
material equal on at least 99.9% of rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.models import animated_csg_scene as j_anim
from csgrenderer_tpu.models import config3_csg_scene as j_c3
from csgrenderer_tpu.models import many_objects_scene as j_many
from csgrenderer_tpu.render import interval as jiv
from csgrenderer_tpu.render import intersect as jint
from csgrenderer_tpu.render import tape_eval as jte
from csgrenderer_tpu.render.integrator import tape_hit_adapter as j_adapter
from csgrenderer_tpu_torch.convert import tape_from_numpy
from csgrenderer_tpu_torch.render import interval as tiv
from csgrenderer_tpu_torch.render import intersect as tint
from csgrenderer_tpu_torch.render import tape_eval as tte, tape_hit_adapter

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
    return tape_from_numpy(*(getattr(jt, f) for f in STATIC), *(np.asarray(getattr(jt, f)) for f in ARRAYS))


def _within_ulp(got, ref, ulps=1):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    gap = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
    bad = ~same & ~(gap <= ulps * ulp)
    assert not bad.any(), f"{bad.sum()} values off by more than {ulps} ulp: {got[bad][:5]} vs {ref[bad][:5]}"


@pytest.fixture(scope="module")
def local_rays():
    """4096 local rays: random, axis-parallel, and starting inside."""
    rng = np.random.default_rng(42)
    n = 4096
    o = rng.uniform(-2.0, 2.0, (n, 3))
    d = rng.normal(size=(n, 3))
    d[:512, 0] = 0.0  # d_x == 0
    d[512:1024, 1] = 0.0  # d_y == 0 (parallel to the y = 0 half-space, the cylinder's caps)
    d[1024:1536, 2] = 0.0
    d[1536:1792, [0, 2]] = 0.0  # along the cylinder axis
    o[2048:2560] *= 0.2  # inside every solid below
    o[2560:2600, 1] = 0.0  # on the half-space's plane
    return o.astype(np.float32), d.astype(np.float32)


INTERVALS = {
    "sphere": (lambda m, o, d: m.sphere_interval(o, d, 0.8), None),
    "halfspace": (lambda m, o, d, n: m.halfspace_interval(o, d, n), (0.0, 1.0, 0.0)),
    "halfspace-tilted": (lambda m, o, d, n: m.halfspace_interval(o, d, n), (0.6, 0.0, 0.8)),
    "box": (lambda m, o, d, he: m.box_interval(o, d, he), (0.7, 0.4, 1.1)),
    "cylinder": (lambda m, o, d: m.cylinder_interval(o, d, 0.6, 0.9), None),
}


@pytest.mark.parametrize("name", sorted(INTERVALS))
def test_leaf_interval_matches_jax(local_rays, name):
    fn, extra = INTERVALS[name]
    o, d = local_rays
    j_args = (jnp.asarray(o), jnp.asarray(d))
    t_args = (_t(o), _t(d))
    if extra is not None:
        e = np.asarray(extra, np.float32)
        j_args, t_args = j_args + (jnp.asarray(e),), t_args + (_t(e),)
    ref = fn(jint, *j_args)
    got = fn(tint, *t_args)
    for g, r in zip(got, ref):
        _within_ulp(g.numpy(), r)
    enter, exit_ = (g.numpy() for g in got)
    inside = (enter <= 0) & (exit_ > 0)
    assert inside[2048:2560].mean() > 0.9 or name.startswith("halfspace")
    assert (enter < exit_).any() and (enter > exit_).any()


@pytest.mark.parametrize("name", ["sphere", "halfspace", "box", "cylinder"])
def test_local_normal_matches_jax(local_rays, name):
    p, _ = local_rays
    he = np.asarray((0.7, 0.4, 1.1), np.float32)
    n = np.asarray((0.0, 1.0, 0.0), np.float32)
    calls = {
        "sphere": (lambda m, P, A: m.sphere_normal(P, A), np.linalg.norm(p, axis=-1).astype(np.float32)),
        "halfspace": (lambda m, P, A: m.halfspace_normal(P, A), n),
        "box": (lambda m, P, A: m.box_normal(P, A), he),
        "cylinder": (lambda m, P, A: m.cylinder_normal(P, A, 0.9), np.float32(0.6)),
    }
    fn, arg = calls[name]
    ref = fn(jint, jnp.asarray(p), jnp.asarray(arg))
    got = fn(tint, _t(p), _t(arg))
    _within_ulp(got.numpy(), ref)


def _random_lists(seed, n=2048, k=3):
    """Pairs of valid sorted disjoint K-slot lists, with empty slots and ties."""
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(2):
        pts = np.sort(rng.integers(0, 12, (n, 2 * k)).astype(np.float32) * 0.5, axis=-1)
        t_in, t_out = pts[:, 0::2].copy(), pts[:, 1::2].copy()
        empty = (t_in >= t_out) | (rng.random((n, k)) < 0.2)
        t_in[empty] = jiv.T_FAR
        t_out[empty] = jiv.T_FAR
        order = np.argsort(t_in, axis=-1, kind="stable")
        lists.append((np.take_along_axis(t_in, order, -1), np.take_along_axis(t_out, order, -1)))
    return lists


@pytest.mark.parametrize("op", ["union", "intersect", "diff"])
def test_combine_matches_jax_exactly(op):
    a, b = _random_lists(7 + len(op))
    ref = jiv.combine(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), op=op,
                      with_dropped=True)
    got = tiv.combine(tuple(map(_t, a)), tuple(map(_t, b)), op=op, with_dropped=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert np.asarray(ref[2]).max() > 0 or op == "intersect"  # capacity overflow is exercised
    for g, r in zip(tiv.combine(tuple(map(_t, a)), tuple(map(_t, b)), op=op, k=5),
                    jiv.combine(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), op=op, k=5)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_single_list_first_surface_and_origin_match_jax_exactly(local_rays):
    o, d = local_rays
    enter, exit_ = jint.sphere_interval(jnp.asarray(o), jnp.asarray(d), 0.8)
    ref_list = jiv.single_to_list(enter, exit_, 4)
    got_list = tiv.single_to_list(_t(np.asarray(enter)), _t(np.asarray(exit_)), 4)
    for g, r in zip(got_list, ref_list):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    a, b = _random_lists(3)
    for lst in (a, b, tuple(np.asarray(x) for x in ref_list)):
        for g, r in zip(tiv.first_surface(*map(_t, lst)), jiv.first_surface(*map(jnp.asarray, lst))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(tiv.inside_at_origin(*map(_t, lst)).numpy(),
                                      np.asarray(jiv.inside_at_origin(*map(jnp.asarray, lst))))
    e_ref = jiv.empty_list((5,), 3)
    for g, r in zip(tiv.empty_list((5,), 3), e_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _cam_rays(jt_cam, w, h, seed):
    rng = np.random.default_rng(seed)
    st = rng.random((2, h, w)).astype(np.float32)
    o, d = jt_cam.rays(jnp.asarray(st[0]), jnp.asarray(st[1]))
    return np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def _secondary_rays(n, seed, center=(0.0, 0.5, 0.0), spread=2.0):
    rng = np.random.default_rng(seed)
    o = (np.asarray(center) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _deep_tape(t):
    g, animate = j_anim(8)
    return animate(g.compile(k=4), t)


HIT_CASES = {
    "config3": (lambda: j_c3().compile(k=2),
                lambda: JCamera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35, aspect_ratio=1.0)),
    "deepcsg": (lambda: _deep_tape(1.0),
                lambda: JCamera.look_at((0, 2.0, 7.0), (0.5, 0, 0), vfov_degrees=40, aspect_ratio=1.0)),
    "many-objects-6": (lambda: j_many(6).compile(k=4),
                       lambda: JCamera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0,
                                               aspect_ratio=1.0)),
}


@pytest.mark.parametrize("case", sorted(HIT_CASES))
def test_tape_nearest_hit_matches_jax(case):
    jt = HIT_CASES[case][0]()
    o1, d1 = _cam_rays(HIT_CASES[case][1](), 48, 48, seed=1)
    o2, d2 = _secondary_rays(2048, seed=2)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    ref = jte.tape_nearest_hit(jt, jnp.asarray(o), jnp.asarray(d))
    got = tte.tape_nearest_hit(port_tape(jt), _t(o), _t(d))
    hit_r, hit_g = np.asarray(ref.hit), got.hit.numpy()
    assert hit_r.any() and not hit_r.all()
    assert (hit_g == hit_r).mean() >= 0.999
    both = hit_g & hit_r
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both], rtol=0, atol=1e-5)
    for f in ("entering", "mat_kind"):
        assert (getattr(got, f).numpy()[both] == np.asarray(getattr(ref, f))[both]).mean() >= 0.999, f
    same_owner = np.all(got.albedo.numpy() == np.asarray(ref.albedo), axis=-1)[both]
    assert same_owner.mean() >= 0.999
    np.testing.assert_allclose(got.normal.numpy()[both][same_owner],
                               np.asarray(ref.normal)[both][same_owner], rtol=0, atol=1e-4)


def test_hit_adapter_and_dropped_spans_match_jax():
    jt = _deep_tape(1.0)
    jt_k1 = j_c3().compile(k=1)  # capacity 1 drops spans behind the cylinder's bore
    o, d = _secondary_rays(2048, seed=5, center=(0.3, 0.0, 0.0))
    ref = j_adapter(jt, jnp.asarray(o), jnp.asarray(d))
    got = tape_hit_adapter(port_tape(jt), _t(o), _t(d))
    both = got.hit.numpy() & np.asarray(ref.hit)
    assert (got.hit.numpy() == np.asarray(ref.hit)).mean() >= 0.999
    assert (got.front_face.numpy()[both] == np.asarray(ref.front_face)[both]).mean() >= 0.999
    np.testing.assert_allclose(got.normal.numpy()[both], np.asarray(ref.normal)[both], atol=1e-4)
    drop_ref = np.asarray(jte.tape_dropped_spans(jt_k1, jnp.asarray(o), jnp.asarray(d)))
    drop_got = tte.tape_dropped_spans(port_tape(jt_k1), _t(o), _t(d)).numpy()
    assert drop_ref.max() > 0
    assert (drop_got == drop_ref).mean() >= 0.999
