"""The interval-list audit mode through the port (the twin of
tests/test_interval_overflow.py): ``render_image_tape_kernel(...,
with_overflow=True)`` on CPU tensors, its plain version, against the JAX
package's Pallas tape kernel in interpret mode.

Bounds: the dropped-span count ``over`` is EQUAL to JAX's; the image is
within tests/test_kernels.py::compare (RMSE <= 2e-2, at most 1% of pixels
off by more than 0.05 in any channel) and the ray counts are equal.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels.tape_kernel import render_image_tape_pallas
from csgrenderer_tpu.scene import Material as JMat, NodeArgument as JNA, SceneGraph as JGraph
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.models import animated_csg_scene, config3_csg_scene, csg_night_scene
from csgrenderer_tpu_torch.render import interval
from csgrenderer_tpu_torch.render.tape_eval import tape_dropped_spans
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph

PEARL_CAM = dict(lookfrom=(0, 0, -6), lookat=(0, 0, 1), vfov_degrees=30.0, aspect_ratio=1.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _three_pearls(k, graph=SceneGraph, mat=Material, arg=NA):
    """Union of three disjoint spheres along +z: 3 spans > k=2 slots (either
    package's scene graph)."""
    g = graph()
    s1 = g.add_sphere_node(0.4, mat.lambertian((0.8, 0.2, 0.2)))
    s2 = g.add_sphere_node(0.4, mat.lambertian((0.2, 0.8, 0.2)))
    s3 = g.add_sphere_node(0.4, mat.lambertian((0.2, 0.2, 0.8)))
    u = g.add_union_of_node(arg(s1, offset=(0, 0, 2.0)), arg(s2, offset=(0, 0, 4.0)))
    g.add_union_of_node(arg(u), arg(s3, offset=(0, 0, 6.0)))
    return g.compile(k=k)


def assert_compare(ref, ref_rays, img, rays):
    ref, img = np.asarray(ref), np.asarray(img)
    assert img.shape == ref.shape and np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    assert rmse <= 2e-2, f"rmse {rmse}"
    frac_bad = float((np.abs(ref - img).max(axis=-1) > 0.05).mean())
    assert frac_bad <= 0.01, f"{frac_bad:.3%} divergent pixels"
    assert int(rays) == int(ref_rays)


def test_combine_reports_dropped():
    # two 2-span lists unioning to 4 disjoint spans in k=2 slots
    def one(a, b):
        return interval.single_to_list(torch.tensor([a]), torch.tensor([b]), 2)

    ab = interval.combine(one(1.0, 2.0), one(3.0, 4.0), op="union", k=2)  # 2 spans: fits
    cd = interval.combine(one(5.0, 6.0), one(7.0, 8.0), op="union", k=2)
    t_in, _, dropped = interval.combine(ab, cd, op="union", k=2, with_dropped=True)
    assert int(dropped[0]) == 2  # 4 spans - 2 slots
    np.testing.assert_allclose(t_in[0].numpy(), [1.0, 3.0], atol=1e-6)


def test_tape_overflow_fires_on_deep_ray():
    tape = _three_pearls(k=2)
    d = torch.tensor([[0.0, 0.0, 1.0]])
    assert int(tape_dropped_spans(tape, torch.tensor([[0.0, 0.0, -5.0]]), d)[0]) == 1
    # an off-axis ray sees at most one sphere: exact
    assert int(tape_dropped_spans(tape, torch.tensor([[10.0, 0.0, -5.0]]), d)[0]) == 0


@pytest.mark.parametrize("k", [2, 4])
def test_kernel_overflow_counter_matches_jax(k):
    """The three pearls at 16x16, 1 spp, 1 bounce: central rays cross all
    three pearls, so k = 2 drops spans and k = 4 is exact; the port's count
    equals JAX's interpret-mode kernel's."""
    kw = dict(spp=1, max_bounces=1, seed=0, with_overflow=True)
    ref, ref_rays, ref_over = render_image_tape_pallas(
        _three_pearls(k, JGraph, JMat, JNA), JCamera.look_at(**PEARL_CAM), 16, 16,
        interpret=True, **kw)
    before = dict(tk.LAUNCHES_BY_MODE)
    img, rays, over = tk.render_image_tape_kernel(_three_pearls(k), Camera.look_at(**PEARL_CAM),
                                                  16, 16, **kw)
    assert tk.LAUNCHES_BY_MODE == before  # CPU tensors: the plain version, no launch
    assert over.dtype == torch.int64 and over.shape == ()
    assert int(over) == int(ref_over)
    assert (int(over) > 0) == (k == 2)
    assert_compare(ref, ref_rays, img, rays)


def _audit(tape, eye, at, vfov, size, **kw):
    cam = Camera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=1.0)
    return tk.render_image_tape_kernel(tape, cam, size, size, with_overflow=True, **kw)


@pytest.mark.parametrize("config", ["config3-k2", "config5-k4"])
def test_benchmark_configs_do_not_overflow(config):
    """The BASELINE CSG configs are exact at their shipped k, on primary and
    bounce segments."""
    if config == "config3-k2":
        tape, view = config3_csg_scene().compile(k=2), ((3, 2.5, 4), (0.1, 0, 0), 35.0)
    else:
        graph, animate = animated_csg_scene(8)
        tape, view = animate(graph.compile(k=4), 1.0), ((0, 2.0, 7.0), (0.5, 0, 0), 40.0)
    img, rays, over = _audit(tape, *view, 32, spp=2, max_bounces=4, seed=0)
    assert int(over) == 0
    event, event_rays = tk.render_image_tape_kernel(
        tape, Camera.look_at(*view[:2], vfov_degrees=view[2], aspect_ratio=1.0), 32, 32, spp=2,
        max_bounces=4, seed=0)
    assert torch.equal(img, event) and int(rays) == int(event_rays)


def test_event_path_is_exact_beyond_capacity():
    """The event flip has no interval capacity: the pearls render the same
    at k = 2 and k = 4, while the audit at k = 2 counts the spans its lists
    drop."""
    cam = Camera.look_at(**PEARL_CAM)
    kw = dict(spp=2, max_bounces=3, seed=3)
    img_k2, _ = tk.render_image_tape_kernel(_three_pearls(2), cam, 24, 24, **kw)
    img_k4, _ = tk.render_image_tape_kernel(_three_pearls(4), cam, 24, 24, **kw)
    assert torch.equal(img_k2, img_k4)
    _, _, over = tk.render_image_tape_kernel(_three_pearls(2), cam, 24, 24, with_overflow=True,
                                             **kw)
    assert int(over) > 0


def _lit_pearls(k, graph=SceneGraph, mat=Material, arg=NA):
    """Three wider pearls, a lamp leaf above them and a diffuse backdrop
    behind them: bounce rays off the backdrop cross the pearls, so the
    bounce segments drop spans at k = 2 as well as the primary rays."""
    g = graph()
    s1 = g.add_sphere_node(0.8, mat.lambertian((0.8, 0.2, 0.2)))
    s2 = g.add_sphere_node(0.8, mat.lambertian((0.2, 0.8, 0.2)))
    s3 = g.add_sphere_node(0.8, mat.lambertian((0.2, 0.2, 0.8)))
    lamp = g.add_sphere_node(0.5, mat.emissive((4.0, 4.0, 4.0)))
    wall = g.add_sphere_node(3.0, mat.lambertian((0.7, 0.7, 0.7)))
    u = g.add_union_of_node(arg(s1, offset=(0, 0, 2.0)), arg(s2, offset=(0, 0, 4.0)))
    p = g.add_union_of_node(arg(u), arg(s3, offset=(0, 0, 6.0)))
    q = g.add_union_of_node(arg(p), arg(lamp, offset=(0, 2.0, 3.0)))
    g.add_union_of_node(arg(q), arg(wall, offset=(0, 0, 11.3)))
    return g.compile(k=k)


def test_audit_with_nee_matches_jax():
    """Audit and NEE together against JAX's interpret-mode kernel, over
    primary and bounce segments: ``over`` equal, the image within compare,
    rays equal, and the image equal to the port's own clustered-nee image.

    A bounce leaves its surface at t ~ 0, where that leaf's exit can round
    to either side of 0 and add a sliver span; on a frame where a 1-ulp
    difference of the bounce origin flips one, the two packages' counts
    differ by it. This frame has no such flip."""
    cam = dict(lookfrom=(0, 0, -6), lookat=(0, 0, 1), vfov_degrees=30.0, aspect_ratio=1.0)
    kw = dict(spp=2, max_bounces=3, seed=1, sky="black", nee=True, with_overflow=True)
    ref, ref_rays, ref_over = render_image_tape_pallas(
        _lit_pearls(2, JGraph, JMat, JNA), JCamera.look_at(**cam), 24, 24, interpret=True, **kw)
    tape = _lit_pearls(2)
    img, rays, over = tk.render_image_tape_kernel(tape, Camera.look_at(**cam), 24, 24, **kw)
    assert int(over) == int(ref_over)
    assert_compare(ref, ref_rays, img, rays)
    event, _ = tk.render_image_tape_kernel(tape, Camera.look_at(**cam), 24, 24,
                                           **{**kw, "with_overflow": False})
    assert torch.equal(img, event)
    # the bounce segments add to the primary rays' count
    _, _, primary = tk.render_image_tape_kernel(tape, Camera.look_at(**cam), 24, 24,
                                                **{**kw, "max_bounces": 1})
    assert 0 < int(primary) < int(over)


def test_audit_with_nee_on_csgnight():
    """Audit and NEE together on a small csgnight: the shadow rays keep the
    event flip, so at k = 4 (no span dropped) the audit image is the
    clustered-nee image; at k = 2 the lists drop spans."""
    cam = Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0, aspect_ratio=2.0)
    kw = dict(spp=2, max_bounces=4, seed=1, sky="black", nee=True)
    tape4 = csg_night_scene().compile(k=4)
    img, rays, over = tk.render_image_tape_kernel(tape4, cam, 32, 16, with_overflow=True, **kw)
    event, event_rays = tk.render_image_tape_kernel(tape4, cam, 32, 16, **kw)
    assert int(over) == 0
    assert torch.equal(img, event) and int(rays) == int(event_rays)
    assert float(img.max()) > 0.0
    _, _, over2 = tk.render_image_tape_kernel(csg_night_scene().compile(k=2), cam, 32, 16,
                                              with_overflow=True, **kw)
    assert int(over2) > 0
