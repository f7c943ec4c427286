"""The CSG tape slice as a whole: ``render_image_tape_kernel`` on CPU tensors
(its plain event-flip version) against the JAX package's Pallas tape kernel
in interpret mode, on the scenes and sizes of tests/test_tape_kernel.py;
plus the packer, the partition modes and the refusals.

Bounds: those of tests/test_kernels.py::compare (RMSE <= 2e-2, at most 1%
of pixels off by more than 0.05 in any channel, rays within
max(2e-3 * ref, 8)); the ray counts are equal, as the JAX test asserts.
The measured RMSE is printed; 1e-4, the JAX test's own bound, is asserted
too, and holds on every scene here.
"""

import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels.tape_kernel import render_image_tape_pallas
from csgrenderer_tpu.math import quaternion as jquat
from csgrenderer_tpu.models import animated_csg_scene as j_anim
from csgrenderer_tpu.models import config3_csg_scene as j_c3
from csgrenderer_tpu.scene import Material as JMat, NodeArgument as JNA, SceneGraph as JGraph
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.convert import camera_from_numpy, tape_from_numpy
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.models import animated_csg_scene, config3_csg_scene, many_objects_scene
from csgrenderer_tpu_torch.render import render_image, tape_hit_adapter
from csgrenderer_tpu_torch.scene import Material, NodeArgument as NA, SceneGraph, partition_tape

STATIC = ("ops", "leaf_types", "leaf_chains", "k", "stack_depth")
ARRAYS = ("leaf_params", "edge_quat", "edge_off", "leaf_rot", "leaf_pos", "mat_kind", "albedo",
          "mat_param")
CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_of(jtape, jcam):
    tape = tape_from_numpy(*(getattr(jtape, f) for f in STATIC),
                           *(np.asarray(getattr(jtape, f)) for f in ARRAYS))
    return tape, camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS))


def assert_compare(ref, ref_rays, img, rays):
    ref, img = np.asarray(ref), np.asarray(img)
    assert img.shape == ref.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((ref - img) ** 2)))
    assert rmse <= 2e-2, f"rmse {rmse}"
    frac_bad = float((np.abs(ref - img).max(axis=-1) > 0.05).mean())
    assert frac_bad <= 0.01, f"{frac_bad:.3%} divergent pixels"
    assert abs(int(rays) - int(ref_rays)) <= max(int(ref_rays) * 2e-3, 8)
    return rmse


def _cam(eye, at, vfov):
    return JCamera.look_at(eye, at, vfov_degrees=vfov, aspect_ratio=1.0)


def _j_deep4():
    g, animate = j_anim(4)
    return animate(g.compile(k=2), 1.0)


def _j_rotated():
    q = tuple(np.asarray(jquat.from_axis_angle(np.array([0.0, 1.0, 0.0]), 0.6)))
    g = JGraph()
    b = g.add_box_node((0.7, 0.7, 0.7), JMat.metal((0.9, 0.8, 0.6), 0.05))
    c = g.add_cylinder_node(0.5, 1.2, JMat.dielectric(1.5))
    hs = g.add_infinite_planar_partition_node((0.0, 1.0, 0.0), JMat.lambertian((0.4, 0.5, 0.6)))
    u = g.add_union_of_node(JNA(b, orientation=q), JNA(c))
    g.add_union_of_node(JNA(u), JNA(hs, offset=(0, -1.2, 0)))
    return g.compile(k=2)


def _j_glass_shell():
    g = JGraph()
    outer = g.add_sphere_node(1.0, JMat.dielectric(1.5))
    inner = g.add_sphere_node(0.6, JMat.dielectric(1.5))
    g.add_difference_of_node(JNA(outer), JNA(inner))
    return g.compile(k=2)


def _j_emissive():
    g = JGraph()
    g.add_sphere_node(1.0, JMat.emissive((2.0, 1.0, 0.5)))
    return g.compile(k=2)


def _j_normal_map():
    g = JGraph(max_node_count=16)
    s = g.add_sphere_node(1.0, JMat.normal_map())
    b = g.add_box_node((0.8, 0.8, 0.8), JMat.normal_map())
    c = g.add_cylinder_node(0.55, 1.6, JMat.normal_map())
    u = g.add_union_of_node(JNA(s, offset=(-0.3, 0, 0)), JNA(b, offset=(0.5, 0, 0)))
    g.add_difference_of_node(JNA(u), JNA(c))
    return g.compile(k=2)


# the scenes and sizes of tests/test_tape_kernel.py
SCENES = {
    "config3": (lambda: j_c3().compile(k=2), lambda: _cam((3, 2.5, 4), (0.1, 0, 0), 35),
                dict(width=32, height=32, spp=1, max_bounces=3, seed=3)),
    "deep-csg": (_j_deep4, lambda: _cam((0, 2.0, 7.0), (0.5, 0, 0), 40),
                 dict(width=24, height=24, spp=1, max_bounces=3, seed=5)),
    "rotated-leaves-materials": (_j_rotated, lambda: _cam((3, 2, 4), (0, 0, 0), 40),
                                 dict(width=24, height=24, spp=1, max_bounces=3, seed=7)),
    "entering-on-difference": (_j_glass_shell, lambda: _cam((0, 0, 3), (0, 0, 0), 45),
                               dict(width=24, height=24, spp=1, max_bounces=5, seed=9)),
    "black-sky": (_j_emissive, lambda: _cam((0, 0, 4), (0, 0, 0), 45),
                  dict(width=32, height=32, spp=1, max_bounces=2, seed=1, sky="black")),
    "normal-map-attribution": (_j_normal_map, lambda: _cam((3, 2.5, 4), (0.1, 0, 0), 35),
                               dict(width=48, height=48, spp=1, max_bounces=1, seed=3)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_slice_matches_pallas_interpret(name):
    make_tape, make_cam, kw = SCENES[name]
    jtape, jcam = make_tape(), make_cam()
    ref, ref_rays = render_image_tape_pallas(jtape, jcam, interpret=True, **kw)
    tape, cam = port_of(jtape, jcam)
    launches = (tk.LAUNCHES, dict(tk.LAUNCHES_BY_MODE))
    img, rays = tk.render_image_tape_kernel(tape, cam, **kw)
    assert (tk.LAUNCHES, dict(tk.LAUNCHES_BY_MODE)) == launches  # CPU tensors never launch
    assert rays.dtype == torch.int64 and img.device.type == "cpu"
    assert tuple(img.shape) == (kw["height"], kw["width"], 3)
    rmse = assert_compare(ref, ref_rays, img.numpy(), rays)
    print(f"{name}: rmse {rmse:.3e} vs the Pallas kernel (interpret mode)")
    assert rmse <= 1e-4
    assert int(rays) == int(ref_rays)
    if name == "black-sky":
        assert float(img[0, 0].max()) == 0.0 and float(img[16, 16].max()) > 1.0


def test_event_flip_equals_interval_reference_on_cpu():
    """The plain event-flip render against the port's interval-list
    reference (render_image with tape_hit_adapter): the same surfaces, and
    attribution that differs only in the box normal's rule."""
    tape = config3_csg_scene().compile(k=4)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=2.0)
    kw = dict(width=48, height=24, spp=2, max_bounces=4, seed=11)
    img, rays = tk.render_image_tape_kernel(tape, cam, **kw)
    ref, ref_rays = render_image(lambda o, d: tape_hit_adapter(tape, o, d), cam, **kw)
    assert_compare(ref.numpy(), ref_rays, img.numpy(), rays)


def _many6_cam(aspect=2.0):
    return Camera.look_at((0, 7.0, 9.0), (0, 0.4, 0), vfov_degrees=45.0, aspect_ratio=aspect)


def test_partition_on_equals_off():
    """partition=True (clustered) and False (global) on many_objects_scene(6)
    (tests/test_partition.py::test_partition_off_equivalence_small)."""
    tape = many_objects_scene(6).compile(k=4)
    assert partition_tape(tape) is not None
    kw = dict(width=48, height=24, spp=2, max_bounces=4, seed=3)
    on, r_on = tk.render_image_tape_kernel(tape, _many6_cam(), partition=True, **kw)
    off, r_off = tk.render_image_tape_kernel(tape, _many6_cam(), partition=False, **kw)
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1e-5)
    assert int(r_on) == int(r_off)


def test_pack_program_tables():
    tape = many_objects_scene(6).compile(k=4)
    clustered = tk.pack_program(tape)
    assert clustered.mode == "clustered" and clustered.clusters == partition_tape(tape)
    assert clustered.leaf_table.shape == (tape.n_leaves, 16)
    table = clustered.cluster_table.tolist()
    assert len(table) == len(clustered.clusters) == 7
    ops = clustered.ops.tolist()
    for (op_off, op_n, id_off, id_n), (c_ops, c_leaves) in zip(table, clustered.clusters):
        assert clustered.leaf_ids.tolist()[id_off:id_off + id_n] == list(c_leaves)
        assert [code & 3 for code in ops[op_off:op_off + op_n]] == [o for o, _ in c_ops]
        slots = [code >> 2 for code in ops[op_off:op_off + op_n] if code & 3 == 0]
        assert slots == list(range(id_n))  # each leaf appears once, in slot order
    glob = tk.pack_program(tape, partition=False)
    assert glob.mode == "global" and glob.cluster_table.tolist() == [[0, len(tape.ops), 0, tape.n_leaves]]
    assert tk.pack_program(tape, partition=()).mode == "global"
    assert tk.pack_program(tape, partition=partition_tape(tape)).clusters == clustered.clusters
    np.testing.assert_array_equal(glob.leaf_table[:, 11].numpy(), tape.mat_kind.numpy())
    np.testing.assert_array_equal(glob.leaf_table[:, 4:7].numpy(), tape.leaf_pos.numpy())
    # config5 at t = 1.0 splits into two clusters, so "auto" is clustered there
    g, animate = animated_csg_scene(8)
    deep = tk.pack_program(animate(g.compile(k=4), 1.0))
    assert deep.mode == "clustered" and sorted(len(c[1]) for c in deep.clusters) == [2, 6]


def test_packed_tape_is_reused_and_partition_fixed():
    tape = many_objects_scene(4).compile(k=4)
    packed = tk.pack_program(tape, partition=False)
    cam = _many6_cam()
    a, ra = tk.render_image_tape_kernel(packed, cam, 16, 8, spp=1, max_bounces=2)
    b, rb = tk.render_image_tape_kernel(tape, cam, 16, 8, spp=1, max_bounces=2, partition=False)
    assert torch.equal(a, b) and int(ra) == int(rb)
    with pytest.raises(ValueError, match="partition"):
        tk.render_image_tape_kernel(packed, cam, 16, 8, partition=True)
    assert packed.to("cpu").mode == "global"


def _deep_chain(n_leaves):
    """A right-nested union of overlapping spheres: stack depth n_leaves."""
    g = SceneGraph(max_node_count=2 * n_leaves + 2)
    leaves = [g.add_sphere_node(1.0, Material.lambertian((0.5, 0.5, 0.5))) for _ in range(n_leaves)]
    node = leaves[-1]
    for leaf in reversed(leaves[:-1]):
        node = g.add_union_of_node(NA(leaf), NA(node))
    return g.compile(k=2)


def test_refusals():
    tape = config3_csg_scene().compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=1.0)
    big = many_objects_scene(129).compile(k=4)
    assert big.n_leaves > tk.MAX_LEAVES
    with pytest.raises(ValueError, match="leaves"):
        tk.render_image_tape_kernel(big, cam, 8, 8)
    deep = _deep_chain(tk.MAX_STACK + 1)
    assert deep.stack_depth == tk.MAX_STACK + 1
    with pytest.raises(ValueError, match="stack depth"):
        tk.render_image_tape_kernel(deep, cam, 8, 8)
    assert tk.pack_program(_deep_chain(tk.MAX_STACK)).mode == "global"  # at the cap: fine
    with pytest.raises(ValueError, match="audit mode takes at most"):
        tk.render_image_tape_kernel(config3_csg_scene().compile(k=tk.MAX_K + 1), cam, 8, 8,
                                    with_overflow=True)
    with pytest.raises(ValueError, match="emissive"):  # config3 has no lamp to sample
        tk.render_image_tape_kernel(tape, cam, 8, 8, nee=True)
    with pytest.raises(NotImplementedError, match="jitters"):  # pixel centres: CPU only
        tk.render_image_tape_kernel(tk.pack_program(tape).to("meta"), cam.to("meta"), 8, 8,
                                    jitter=False)
    with pytest.raises(ValueError, match="partition=True"):
        tk.render_image_tape_kernel(tape, cam, 8, 8, partition=True)
    with pytest.raises(ValueError, match="sky"):
        tk.render_image_tape_kernel(tape, cam, 8, 8, sky="sunset")


def test_overflow_mode_returns_the_dropped_spans():
    """``with_overflow=True`` returns (image, rays, over), over an int64
    scalar, with any partition and with NEE; its image and rays are the
    event flip's where no span is dropped, and the packed list ops are the
    whole tape's, clusters or not."""
    tape = many_objects_scene(6).compile(k=4)
    cam = _many6_cam()
    kw = dict(spp=1, max_bounces=3, seed=2)
    for partition in ("auto", False):
        packed = tk.pack_program(tape, partition)
        assert packed.list_ops.tolist() == [
            opc | (arg << 2) if opc == 0 else opc for opc, arg in tape.ops]
        img, rays, over = tk.render_image_tape_kernel(packed, cam, 16, 8, with_overflow=True,
                                                      **kw)
        assert over.dtype == torch.int64 and int(over) == 0
        ref, ref_rays = tk.render_image_tape_kernel(packed, cam, 16, 8, **kw)
        assert torch.equal(img, ref) and int(rays) == int(ref_rays)
    plain = tk.render_image_tape_plain(tk.pack_program(tape), cam, 16, 8, with_overflow=True, **kw)
    assert len(plain) == 3 and torch.equal(plain[0], img)


def test_cuda_request_without_cuda_raises():
    """A tape and camera on "cuda" where CUDA is absent raise; nothing falls
    back to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would be served")
    tape = config3_csg_scene().compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=1.0)
    before = tk.LAUNCHES
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        tk.render_image_tape_kernel(tk.pack_program(tape).to("cuda"), cam, 8, 8)
    assert tk.LAUNCHES == before


def test_non_cpu_non_cuda_tensors_raise():
    tape = config3_csg_scene().compile(k=2)
    cam = Camera.look_at((3, 2.5, 4), (0.1, 0, 0), vfov_degrees=35.0, aspect_ratio=1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.render_image_tape_kernel(tk.pack_program(tape).to("meta"), cam.to("meta"), 8, 8)
