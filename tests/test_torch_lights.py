"""``render/lights.py`` of the port against its JAX twin, function by
function, on the same inputs made from a seed with numpy.

Tolerance: 1e-6 relative (plus a small absolute floor where values pass
through zero) for arithmetic that both packages do in float32 in the
same order. Where a direction goes through ``cos``/``sin`` (the cone
sampler) torch's and XLA's float32 transcendentals may differ by an ulp,
so those values get 2e-6 relative. The fuzzy-metal pdf divides by
g = sqrt(c^2 - 1 + f^2), which goes to 0 at the lobe's cone edge, so an
ulp of difference in the normalizing rsqrt grows there: 1e-5 relative.
The tests say which tolerance they use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.models import csg_night_scene as j_csg_night
from csgrenderer_tpu.models import night_scene as j_night
from csgrenderer_tpu.render import lights as jl
from csgrenderer_tpu.render.integrator import SphereScene as JScene
from csgrenderer_tpu.render.trimesh import concat_meshes, icosphere, quad
from csgrenderer_tpu.scene import Material as JMat
from csgrenderer_tpu.scene import NodeArgument as JNA
from csgrenderer_tpu.scene import SceneGraph as JGraph
from csgrenderer_tpu_torch.convert import lights_from_numpy, sphere_scene_from_numpy, tape_from_numpy
from csgrenderer_tpu_torch.models import config3_csg_scene, csg_night_scene
from csgrenderer_tpu_torch.render import lights as tl
from csgrenderer_tpu_torch.render.integrator import SurfaceHit

SCENE_FIELDS = ("centers", "radii", "mat_kind", "albedo", "mat_param")
STATIC = ("ops", "leaf_types", "leaf_chains", "k", "stack_depth")
ARRAYS = ("leaf_params", "edge_quat", "edge_off", "leaf_rot", "leaf_pos", "mat_kind", "albedo",
          "mat_param")
RTOL = 1e-6
RTOL_TRIG = 2e-6  # through torch's vs XLA's float32 cos/sin
RTOL_EDGE = 1e-5  # the metal pdf's 1/g near its cone edge


def j_small_scene():
    """tests/test_nee.py's small scene: a lamp, a metal sphere, two diffuse."""
    return JScene(
        centers=jnp.asarray([[0, -100.5, -1], [0, 0, -1], [1.2, 0.8, -0.6], [-1.0, 0.1, -0.4]],
                            jnp.float32),
        radii=jnp.asarray([100, 0.5, 0.35, 0.25], jnp.float32),
        mat_kind=jnp.asarray([1, 1, 4, 2], jnp.int32),
        albedo=jnp.asarray([[0.6, 0.6, 0.5], [0.4, 0.2, 0.7], [6.0, 5.0, 4.0], [0.9, 0.9, 0.9]],
                           jnp.float32),
        mat_param=jnp.asarray([0, 0, 0, 0.05], jnp.float32),
    )


def port_scene(jscene):
    return sphere_scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))


def port_lights(jlights):
    return lights_from_numpy(*(np.asarray(f) for f in jlights))


def j_small_csg_night_tape():
    """tests/test_nee.py's 5-leaf emissive CSG scene."""
    g = JGraph(max_node_count=16)
    ground = g.add_infinite_planar_partition_node((0, 1, 0), JMat.lambertian((0.5, 0.5, 0.5)))
    s1 = g.add_sphere_node(1.0, JMat.lambertian((0.7, 0.3, 0.3)))
    b1 = g.add_box_node((0.7, 0.7, 0.7), JMat.metal((0.8, 0.8, 0.9), 0.05))
    solid = g.add_difference_of_node(JNA(s1, offset=(0, 1.0, -3)), JNA(b1, offset=(0.5, 1.4, -2.6)))
    lamp = g.add_sphere_node(0.6, JMat.emissive((6.0, 5.5, 5.0)))
    u1 = g.add_union_of_node(JNA(solid), JNA(lamp, offset=(2.0, 2.5, -2.0)))
    g.add_union_of_node(JNA(u1), JNA(ground))
    return g.compile(k=4)


def j_mesh_night():
    """tests/test_nee.py's mesh scene: an emissive quad over icospheres."""
    return concat_meshes(
        icosphere((-0.9, 0.7, -3.0), 0.7, JMat.lambertian((0.6, 0.3, 0.3)), 2),
        icosphere((1.0, 0.6, -2.7), 0.6, JMat.metal((0.8, 0.7, 0.5), 0.2), 2),
        quad((-0.6, 2.4, -3.2), (0.6, 2.4, -3.2), (0.6, 2.4, -2.0), (-0.6, 2.4, -2.0),
             JMat.emissive((14.0, 12.0, 9.0))),
        quad((-6, 0, -9), (6, 0, -9), (6, 0, 2), (-6, 0, 2), JMat.lambertian((0.5, 0.5, 0.5))),
    )


class _Mesh:
    """A triangle mesh as the port's ``extract_mesh_lights`` reads it."""

    def __init__(self, jmesh):
        for f in ("v0", "e1", "e2", "mat_kind", "albedo"):
            setattr(self, f, torch.from_numpy(np.array(getattr(jmesh, f))))


def close(port, ref, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def pts():
    """Points around the small scene's lamp, normals, uniforms, directions."""
    rng = np.random.default_rng(3)
    n = 512
    p = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random((n, 4), dtype=np.float32)
    d_in = rng.normal(size=(n, 3)).astype(np.float32)
    d_new = rng.normal(size=(n, 3)).astype(np.float32)
    fuzz = (rng.random(n) * 1.2).astype(np.float32)
    fuzz[:32] = 0.0  # mirror metal: no pairable pdf
    return dict(p=p, n=nrm, u=u, d_in=d_in, d_new=d_new, fuzz=fuzz)


def t(x):
    return torch.from_numpy(np.array(x))


def test_extract_lights_matches_jax():
    for jscene in (j_small_scene(), j_night(), j_night(grid=11)):
        jlights, jids = jl.extract_lights(jscene, return_ids=True)
        lights, ids = tl.extract_lights(port_scene(jscene), return_ids=True)
        np.testing.assert_array_equal(ids, jids)
        for a, b in zip(lights, jlights):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        assert tl.extract_lights(port_scene(jscene)).num_lights == len(jids)
    no_em = j_small_scene()._replace(mat_kind=jnp.asarray([1, 1, 1, 2], jnp.int32))
    assert tl.extract_lights(port_scene(no_em)) is None
    lights, ids = tl.extract_lights(port_scene(no_em), return_ids=True)
    assert lights is None and ids.size == 0


def test_extract_tape_lights_matches_jax():
    for jtape in (j_small_csg_night_tape(), j_csg_night().compile(k=4)):
        jlights, jids = jl.extract_tape_lights(jtape, return_ids=True)
        tape = tape_from_numpy(*(getattr(jtape, f) for f in STATIC),
                               *(np.asarray(getattr(jtape, f)) for f in ARRAYS))
        lights, ids = tl.extract_tape_lights(tape, return_ids=True)
        np.testing.assert_array_equal(ids, jids)
        for a, b in zip(lights, jlights):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # the port's own csg_night_scene gives the same lamps as the JAX one
    ours = tl.extract_tape_lights(csg_night_scene().compile(k=4))
    theirs = jl.extract_tape_lights(j_csg_night().compile(k=4))
    for a, b in zip(ours, theirs):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert tl.extract_tape_lights(config3_csg_scene().compile(k=2)) is None


def test_sample_sphere_cone_and_sphere_ray_t(pts):
    c, r = np.float32([1.2, 0.8, -0.6]), np.float32(0.35)
    jd, jinv = jl.sample_sphere_cone(pts["p"], c, r, pts["u"][:, 1], pts["u"][:, 2])
    d, inv = tl.sample_sphere_cone(t(pts["p"]), t(c), torch.tensor(r), t(pts["u"][:, 1]),
                                   t(pts["u"][:, 2]))
    close(inv, jinv)
    close(d, jd, rtol=RTOL_TRIG, atol=1e-6)
    jt = jl.sphere_ray_t(pts["p"], jd, c, r)
    tt = tl.sphere_ray_t(t(pts["p"]), t(np.asarray(jd)), t(c), torch.tensor(r))
    close(tt, jt)
    assert float(tt.max()) < 1e29 or bool((inv == 0).any())  # cone samples hit the lamp
    # inside the lamp there is no cone
    _, inv0 = tl.sample_sphere_cone(t(np.tile(c, (8, 1))), t(c), torch.tensor(r),
                                    t(pts["u"][:8, 1]), t(pts["u"][:8, 2]))
    assert float(inv0.max()) == 0.0


def test_scatter_pdfs(pts):
    close(tl.scatter_pdf_lambertian(t(pts["n"]), t(pts["d_new"])),
          jl.scatter_pdf_lambertian(pts["n"], pts["d_new"]))
    jp = jl.scatter_pdf_metal(pts["d_in"], pts["n"], pts["fuzz"], pts["d_new"])
    p = tl.scatter_pdf_metal(t(pts["d_in"]), t(pts["n"]), t(pts["fuzz"]), t(pts["d_new"]))
    close(p, jp, rtol=RTOL_EDGE, atol=1e-6)
    assert float(p[:32].abs().max()) == 0.0  # mirror metal
    assert float(tl.scatter_pdf_metal(t(pts["d_in"][0]), t(pts["n"][0]), 0.7,
                                      t(pts["d_new"][0]))) == pytest.approx(
        float(jl.scatter_pdf_metal(pts["d_in"][0], pts["n"][0], 0.7, pts["d_new"][0])), rel=RTOL)


def _mis_lights():
    return jl.extract_lights(j_small_scene())


def test_nee_contribution_matches_jax(pts):
    """The whole sphere-lamp estimator with the small scene as occluder, at
    Lambertian and glossy vertices (the metal lobe as pdf_b)."""
    jscene = j_small_scene()
    scene = port_scene(jscene)
    jlights = _mis_lights()
    lights = port_lights(jlights)
    p = pts["p"] + 3.0 * pts["n"]  # lift the points off the ground
    # incoming directions whose mirror direction points at the lamp
    w = np.asarray(jlights.centers[0]) - p
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    d_in = (w - 2.0 * (w * pts["n"]).sum(-1, keepdims=True) * pts["n"]).astype(np.float32)

    def j_pdf(d, cos):
        return jnp.where(cos > 0.0, jl.scatter_pdf_metal(d_in, pts["n"], 0.3, d), 0.0)

    def t_pdf(d, cos):
        return torch.where(cos > 0.0, tl.scatter_pdf_metal(t(d_in), t(pts["n"]), 0.3, d), 0.0)

    alb = np.float32([0.7, 0.5, 0.3])
    for jf, tf, rtol in ((None, None, RTOL_TRIG), (j_pdf, t_pdf, RTOL_EDGE)):
        ref = jl.nee_contribution(jscene.nearest_hit, p, pts["n"], alb, jlights, pts["u"],
                                  pdf_b_fn=jf)
        got, traced, lit = tl.nee_contribution(scene.nearest_hit, t(p), t(pts["n"]), t(alb), lights,
                                               t(pts["u"]), pdf_b_fn=tf, return_masks=True)
        close(got, ref, rtol=rtol, atol=1e-6)
        assert bool((lit <= traced).all()) and 0 < int(lit.sum()) < p.shape[0]
        assert bool(((got.abs().amax(-1) > 0) <= lit).all())
        anyd = tl.nee_contribution_any(scene.nearest_hit, t(p), t(pts["n"]), t(alb), lights,
                                       t(pts["u"]), pdf_b_fn=tf)
        assert torch.equal(anyd, got)


def test_bsdf_mis_scale_matches_jax(pts):
    jlights = _mis_lights()
    lights = port_lights(jlights)
    c, r = np.asarray(jlights.centers[0]), float(jlights.radii[0])
    d, _ = jl.sample_sphere_cone(pts["p"], c, np.float32(r), pts["u"][:, 1], pts["u"][:, 2])
    hitp = np.asarray(pts["p"] + jl.sphere_ray_t(pts["p"], d, c, np.float32(r))[:, None] * d)
    keep = np.abs(hitp).max(axis=1) < 1e3
    prev = pts["u"][:, 3] * 0.5
    ref = jl.bsdf_mis_scale(jlights, pts["p"][keep], hitp[keep], prev[keep])
    got = tl.bsdf_mis_scale(lights, t(pts["p"][keep]), t(hitp[keep]), t(prev[keep]))
    close(got, ref)
    assert torch.equal(tl.bsdf_mis_scale_any(lights, t(pts["p"][keep]), t(hitp[keep]),
                                             t(prev[keep])), got)


def test_mis_weights_partition_unity():
    """tests/test_nee.py::test_mis_weights_partition_unity on the port: the
    light-side weight folded into nee_contribution's scale and the BSDF
    side's bsdf_mis_scale sum to 1; inside the lamp w_B = 1."""
    rng = np.random.default_rng(3)
    lights = port_lights(_mis_lights())
    c, r, nl = lights.centers[0], lights.radii[0], lights.num_lights
    p = t(rng.normal(size=(256, 3)).astype(np.float32) * 2.0)
    p = p[((p - c) ** 2).sum(-1) > (r * 1.5) ** 2]
    u1, u2 = (t(rng.random(p.shape[0], np.float32)) for _ in range(2))
    d, inv_pdf = tl.sample_sphere_cone(p, c, r, u1, u2)
    cos = torch.clamp(d[:, 1], min=1e-4)  # normal (0, 1, 0)
    cli = cos * nl * inv_pdf
    w_l = np.pi / (np.pi + cli)
    hitp = p + tl.sphere_ray_t(p, d, c, r)[:, None] * d
    w_b = tl.bsdf_mis_scale(lights, p, hitp, cos / np.pi)
    np.testing.assert_allclose((w_l + w_b).numpy(), 1.0, atol=1e-5)
    w_in = tl.bsdf_mis_scale(lights, c.expand(4, 3), hitp[:4], cos[:4] / np.pi)
    np.testing.assert_allclose(w_in.numpy(), 1.0, atol=1e-6)


def test_glossy_mis_weights_partition_unity():
    """tests/test_nee.py::test_glossy_mis_weights_partition_unity on the
    port: the same sum for the metal lobe's pdf."""
    rng = np.random.default_rng(5)
    lights = port_lights(_mis_lights())
    c, r, nl = lights.centers[0], lights.radii[0], lights.num_lights
    p = t(rng.normal(size=(128, 3)).astype(np.float32) * 2.0)
    p = p[((p - c) ** 2).sum(-1) > (r * 1.5) ** 2]
    m = p.shape[0]
    u1, u2 = (t(rng.random(m, np.float32)) for _ in range(2))
    d, inv_pdf = tl.sample_sphere_cone(p, c, r, u1, u2)
    n = torch.tensor([0.0, 1.0, 0.0]).expand(m, 3)
    d_in = t(rng.normal(size=(m, 3)).astype(np.float32) - np.float32([0, 3, 0]))
    pdf_m = tl.scatter_pdf_metal(d_in, n, 0.6, d)
    w_l = 1.0 / (1.0 + pdf_m * nl * inv_pdf)
    t_l = tl.sphere_ray_t(p, d, c, r)
    w_b = tl.bsdf_mis_scale(lights, p, p + t_l[:, None] * d, pdf_m)
    keep = t_l < 1e29
    np.testing.assert_allclose((w_l + w_b)[keep].numpy(), 1.0, atol=1e-5)


def _no_hit(p, d):
    z = torch.zeros(p.shape[:-1]) if isinstance(p, torch.Tensor) else jnp.zeros(p.shape[:-1])
    return SurfaceHit(t=z + 1e30, hit=z > 1.0, normal=None, front_face=None, mat_kind=None,
                      albedo=None, mat_param=None)


def test_triangle_lamps_match_jax(pts):
    jmesh = j_mesh_night()
    jlights, jids = jl.extract_mesh_lights(jmesh, return_ids=True)
    lights, ids = tl.extract_mesh_lights(_Mesh(jmesh), return_ids=True)
    np.testing.assert_array_equal(ids, jids)
    for a, b in zip(lights, jlights):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert tl.extract_mesh_lights(_Mesh(icosphere((0, 0, -3), 1.0, JMat.lambertian((0.5,) * 3), 1))) is None

    u = pts["u"]
    close(tl.sample_triangle(lights.v0[:1], lights.e1[:1], lights.e2[:1], t(u[:, 1]), t(u[:, 2])),
          jl.sample_triangle(jlights.v0[:1], jlights.e1[:1], jlights.e2[:1], u[:, 1], u[:, 2]))
    # below the lamp quad, facing up; an occluding sphere scene on both sides
    p = np.float32([0.0, 0.5, -2.6]) + pts["p"] * np.float32([1.0, 0.2, 1.0])
    alb = np.float32([0.6, 0.6, 0.6])
    jocc = j_small_scene()._replace(
        centers=jnp.asarray([[0, -100.5, -1], [0.3, 1.6, -2.6], [5, 5, 5], [6, 6, 6]], jnp.float32))
    for jhit, hit in ((_no_hit, _no_hit), (jocc.nearest_hit, port_scene(jocc).nearest_hit)):
        ref = jl.nee_contribution_tri(jhit, p, pts["n"], alb, jlights, u)
        got, traced, lit = tl.nee_contribution_tri(hit, t(p), t(pts["n"]), t(alb), lights, t(u),
                                                   return_masks=True)
        close(got, ref, rtol=1e-5, atol=1e-6)  # a sqrt and a division deeper than the cone's
        assert bool((lit <= traced).all()) and int(lit.sum()) > 0
        assert torch.equal(tl.nee_contribution_any(hit, t(p), t(pts["n"]), t(alb), lights, t(u)), got)
    # the BSDF-side weight of a hit on the lamp quad
    hitp = np.asarray(jl.sample_triangle(jlights.v0[:1], jlights.e1[:1], jlights.e2[:1],
                                         u[:, 1], u[:, 2]))
    prev = u[:, 3]
    close(tl.bsdf_mis_scale_tri(lights, t(p), t(hitp), t(prev)),
          jl.bsdf_mis_scale_tri(jlights, p, hitp, prev), rtol=1e-5)
    assert torch.equal(tl.bsdf_mis_scale_any(lights, t(p), t(hitp), t(prev)),
                       tl.bsdf_mis_scale_tri(lights, t(p), t(hitp), t(prev)))


def test_lights_from_numpy_round_trips():
    jlights = jl.extract_lights(j_night(grid=11))
    lights = port_lights(jlights)
    assert isinstance(lights, tl.SphereLights) and lights.num_lights == 2
    for a, b in zip(lights, jlights):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    jtri = jl.extract_mesh_lights(j_mesh_night())
    tri = port_lights(jtri)
    assert isinstance(tri, tl.TriLights) and tri.num_lights == 2
    for a, b in zip(tri, jtri):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="lamp arrays"):
        lights_from_numpy(np.zeros((2, 3)), np.zeros(2))
    with pytest.raises(ValueError, match="inconsistent"):
        lights_from_numpy(np.zeros((2, 3)), np.zeros(3), np.zeros((2, 3)))

