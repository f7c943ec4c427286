"""Math, camera, materials, intersection, sky, tonemap and scenes of the
port against their JAX twins, on the same seeded numpy inputs.

Tolerance: rtol = atol = 1e-5 (float32 arithmetic in another framework,
with another summation and fusion order); scenes are byte-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.math import vec as jvec
from csgrenderer_tpu.models import rtiow_final_scene as j_rtiow
from csgrenderer_tpu.models import two_spheres_scene as j_two
from csgrenderer_tpu.render import intersect as jint
from csgrenderer_tpu.render import materials as jmat
from csgrenderer_tpu.render import tonemap as jtone
from csgrenderer_tpu.render.integrator import sky_color as j_sky
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.convert import camera_from_numpy
from csgrenderer_tpu_torch.math import vec as tvec
from csgrenderer_tpu_torch.models import rtiow_final_scene, two_spheres_scene
from csgrenderer_tpu_torch.render import intersect as tint
from csgrenderer_tpu_torch.render import materials as tmat
from csgrenderer_tpu_torch.render import tonemap as ttone
from csgrenderer_tpu_torch.render.integrator import sky_color

TOL = dict(rtol=1e-5, atol=1e-5)
CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.fixture
def vecs():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(257, 3)).astype(np.float32)
    w = rng.normal(size=(257, 3)).astype(np.float32)
    n = w / np.linalg.norm(w, axis=-1, keepdims=True)
    t = rng.random(257).astype(np.float32)
    return v, w, n.astype(np.float32), t


@pytest.mark.parametrize(
    "name", ["dot", "lengthsqr", "length", "normalized", "normalized_ref_bugcompat",
             "cross", "reflect", "lerp", "refract"],
)
def test_vec_matches_jax(vecs, name):
    v, w, n, t = vecs
    if name in ("dot", "cross"):
        args = (v, w)
    elif name == "reflect":
        args = (v, n)
    elif name == "lerp":
        args = (v, w, t)
    elif name == "refract":
        uv = v / np.linalg.norm(v, axis=-1, keepdims=True)
        args = (uv.astype(np.float32), n, (0.5 + t).astype(np.float32))
    else:
        args = (v,)
    ref = getattr(jvec, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tvec, name)(*(_t(a) for a in args))
    _close(got, ref)


@pytest.mark.parametrize("aperture", [0.0, 0.1])
def test_camera_look_at_and_rays_match_jax(aperture):
    kw = dict(vfov_degrees=20.0, aspect_ratio=16 / 9, aperture=aperture, focus_dist=10.0)
    jc = JCamera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), **kw)
    tc = Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), **kw)
    for f in CAM_FIELDS:
        _close(getattr(tc, f), getattr(jc, f))
    # the converted camera is the JAX camera exactly
    cc = camera_from_numpy(*(np.asarray(getattr(jc, f)) for f in CAM_FIELDS))
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(getattr(cc, f).numpy(), np.asarray(getattr(jc, f)))

    rng = np.random.default_rng(1)
    st = rng.random((2, 12, 20)).astype(np.float32)
    lens = rng.random((12, 20, 2)).astype(np.float32) * 0.5
    for lens_uv in (None, lens):
        jo, jd = jc.rays(jnp.asarray(st[0]), jnp.asarray(st[1]),
                         lens_uv=None if lens_uv is None else jnp.asarray(lens_uv))
        to, td = cc.rays(_t(st[0]), _t(st[1]), lens_uv=None if lens_uv is None else _t(lens_uv))
        _close(to, jo)
        _close(td, jd)


def test_camera_default_focus_distance():
    jc = JCamera.look_at((0.0, 1.0, 4.0), (0.0, 0.0, 0.0), vfov_degrees=40.0, aperture=0.2)
    tc = Camera.look_at((0.0, 1.0, 4.0), (0.0, 0.0, 0.0), vfov_degrees=40.0, aperture=0.2)
    for f in CAM_FIELDS:
        _close(getattr(tc, f), getattr(jc, f))


def _scatter_inputs(kind, front, seed, tir=False):
    rng = np.random.default_rng(seed)
    n_ = 512
    n = rng.normal(size=(n_, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(n_, 3)) * 3.0
    # d_in must oppose the (face-forwarded) normal
    d = np.where((np.sum(d * n, -1) > 0)[:, None], -d, d)
    if tir:  # grazing incidence from inside glass: eta * sin > 1
        tang = d - np.sum(d * n, -1, keepdims=True) * n
        d = tang - 0.05 * n * np.linalg.norm(tang, axis=-1, keepdims=True)
    kinds = np.full(n_, kind, np.int32)
    albedo = rng.random((n_, 3)).astype(np.float32)
    param = (1.5 if kind == 3 else 0.3) * np.ones(n_, np.float32)
    param[: n_ // 4] = 0.0 if kind != 3 else 1.0  # mirror metal / index-matched glass
    u = rng.random((n_, 4)).astype(np.float32)
    ff = np.full(n_, front) if front is not None else rng.random(n_) < 0.5
    return (kinds, albedo, param, d.astype(np.float32), n.astype(np.float32), ff, u)


@pytest.mark.parametrize(
    "kind,front,tir",
    [(0, True, False), (1, True, False), (2, True, False), (2, False, False),
     (3, True, False), (3, False, False), (3, False, True), (4, True, False),
     (1, None, False)],
)
def test_scatter_matches_jax(kind, front, tir):
    args = _scatter_inputs(kind, front, seed=10 + kind, tir=tir)
    ref = jmat.scatter(*(jnp.asarray(a) for a in args))
    got = tmat.scatter(*(_t(a) for a in args))
    for r, g in zip(ref, got):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            _close(g, r, rtol=1e-5, atol=2e-5)
    if tir:  # total internal reflection really happened (on the ior 1.5 lanes)
        glass = args[2] > 1.0
        unit = args[3] / np.linalg.norm(args[3], axis=-1, keepdims=True)
        refl = unit - 2 * np.sum(unit * args[4], -1, keepdims=True) * args[4]
        np.testing.assert_allclose(got.direction.numpy()[glass], refl[glass], atol=1e-5)


def test_spheres_nearest_hit_matches_jax():
    """Same hits and spheres; t to rtol 1e-4, not 1e-5: the expanded
    quadratic cancels o.o - 2 o.c + c.c, so a last-bit difference in
    XLA's dot versus the port's ordered sum grows ~10x in t."""
    rng = np.random.default_rng(5)
    s = 40
    centers = rng.uniform(-3, 3, (s, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.8, s).astype(np.float32)
    radii[3] = -0.5  # hollow bubble: same geometry
    centers[7] = 1e15  # pad-style: a huge c-term always misses
    radii[7] = 1.0
    n = 1024
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[0] = centers[3] - o[0]  # aimed at the bubble
    d[1] = -o[1] + np.array([100.0, 100.0, 100.0], np.float32)  # a likely miss
    jt, ji, jh = jint.spheres_nearest_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
                                          jnp.asarray(radii), t_min=1e-3)
    tt, ti, th = tint.spheres_nearest_hit(_t(o), _t(d), _t(centers), _t(radii), t_min=1e-3)
    jh, th = np.asarray(jh), th.numpy()
    np.testing.assert_array_equal(th, jh)
    assert th[0] and not th.all()
    np.testing.assert_allclose(tt.numpy()[th], np.asarray(jt)[jh], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy()[th], np.asarray(ji)[jh])
    assert not (ti.numpy()[th] == 7).any()


def test_hit_sphere_ref_matches_jax():
    rng = np.random.default_rng(6)
    o = np.zeros((300, 3), np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    center = np.array([0.0, 0.3, -2.0], np.float32)
    ref = jint.hit_sphere_ref(jnp.asarray(center), 0.5, jnp.asarray(o), jnp.asarray(d))
    got = tint.hit_sphere_ref(_t(center), 0.5, _t(o), _t(d))
    _close(got, ref)
    assert (got.numpy() == -1.0).any() and (got.numpy() > 0).any()


@pytest.mark.parametrize("mode", ["rtiow", "wololo", "black"])
def test_sky_color_matches_jax(mode):
    d = np.random.default_rng(7).normal(size=(200, 3)).astype(np.float32)
    _close(sky_color(_t(d), mode), j_sky(jnp.asarray(d), mode))


def test_sky_color_rejects_unknown_mode():
    with pytest.raises(ValueError):
        sky_color(torch.ones(2, 3), "sunset")


@pytest.mark.parametrize("gamma", [1.0, 2.0, 2.2])
def test_tonemap_matches_jax(gamma):
    x = np.random.default_rng(8).uniform(-0.2, 1.5, (30, 20, 3)).astype(np.float32)
    ref = jtone.tonemap(jnp.asarray(x), gamma=gamma, exposure=0.9)
    got = ttone.tonemap(_t(x), gamma=gamma, exposure=0.9)
    _close(got, ref)
    np.testing.assert_array_equal(ttone.to_uint8(got).numpy(), np.asarray(jtone.to_uint8(ref)))


SCENES = {
    "rtiow": (rtiow_final_scene, j_rtiow, {}),
    "rtiow-grid4": (rtiow_final_scene, j_rtiow, {"grid": 4}),
    "rtiow-seed7": (rtiow_final_scene, j_rtiow, {"seed": 7, "grid": 3}),
    "two-spheres": (two_spheres_scene, j_two, {}),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scenes_byte_identical(name):
    port, ref, kw = SCENES[name]
    ts, js = port(**kw), ref(**kw)
    for f in ("centers", "radii", "mat_kind", "albedo", "mat_param"):
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("shapes", [((), (), ()), ((4, 1), (5,), ()), ((2, 3), (2, 3), (1, 3))],
                         ids=["scalars", "row-by-column", "mixed"])
def test_vec3_matches_jax(shapes):
    """``vec3`` stacks its broadcast components as JAX's does, float32 by
    default and in the dtype asked for."""
    rng = np.random.default_rng(7)
    parts = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ref = jvec.vec3(*(jnp.asarray(p) for p in parts))
    got = tvec.vec3(*(_t(p) for p in parts))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    from_floats = tvec.vec3(*(float(np.ravel(p)[0]) for p in parts), dtype=torch.float64)
    assert from_floats.dtype == torch.float64 and tuple(from_floats.shape) == (3,)


def test_sample_cosine_hemisphere_matches_jax():
    from csgrenderer_tpu.render import sampling as jsamp
    from csgrenderer_tpu_torch.render import sampling as tsamp

    rng = np.random.default_rng(8)
    n = rng.normal(size=(300, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    u1, u2 = rng.random((2, 300)).astype(np.float32)
    ref = jsamp.sample_cosine_hemisphere(jnp.asarray(n), jnp.asarray(u1), jnp.asarray(u2))
    got = tsamp.sample_cosine_hemisphere(_t(n), _t(u1), _t(u2))
    _close(got, ref)


def test_trace_paths_accepts_and_ignores_eps():
    """``eps`` (JAX's parameter, which it ignores) changes nothing: the hit
    function carries its own t_min."""
    from csgrenderer_tpu_torch.render.integrator import trace_paths

    scene = two_spheres_scene()
    cam = Camera.look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), vfov_degrees=90.0, aspect_ratio=2.0)
    rng = np.random.default_rng(9)
    st = rng.random((2, 8, 16)).astype(np.float32)
    o, d = cam.rays(_t(st[0]), _t(st[1]))
    pixel_id = torch.arange(8 * 16, dtype=torch.int64).reshape(8, 16)
    base = trace_paths(scene.nearest_hit, o, d, pixel_id, 0, 5, 4)
    for eps in (1e-3, 0.5):
        got = trace_paths(scene.nearest_hit, o, d, pixel_id, 0, 5, 4, "rtiow", eps)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


def test_render_exports_are_the_module_functions():
    """The six names the JAX package's ``render`` exports beside its
    modules are the port's own functions, re-exported."""
    from csgrenderer_tpu_torch import render
    from csgrenderer_tpu_torch.render import integrator, trimesh

    for name in ("MeshScene", "concat_meshes", "icosphere", "make_mesh", "quad"):
        assert getattr(render, name) is getattr(trimesh, name)
    assert render.render_wololo_frame is integrator.render_wololo_frame
