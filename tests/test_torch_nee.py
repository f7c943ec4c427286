"""Next-event estimation in the port as a whole, on the CPU: the plain
integrator with ``lights=`` against the JAX reference, the kernel
wrappers' NEE modes (their plain versions here), the night scenes, the
lamp tables and the CLI's csgnight.

Both JAX references run op by op (``jax.disable_jit()``): under ``jit``
XLA fuses the bounce loop and contracts multiply-adds, which moves a
handful of silhouette paths (sphere frame: RMSE 1.3e-4 and two rays; CSG
frame: one ray). Against the op-by-op reference the sphere path is within
RMSE 1e-4 with equal ray counts, and the CSG path within
tests/test_nee.py's bound (at most 1% of pixels off by more than 0.05)
with equal ray counts.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csgrenderer_tpu.camera import Camera as JCamera
from csgrenderer_tpu.kernels.worklist import pack_grid as j_pack_grid
from csgrenderer_tpu.models import night_scene as j_night
from csgrenderer_tpu.render import integrator as j_integrator
from csgrenderer_tpu.render import lights as jl
from csgrenderer_tpu.render.integrator import SphereScene as JScene
from csgrenderer_tpu.scene import Material as JMat
from csgrenderer_tpu.scene import NodeArgument as JNA
from csgrenderer_tpu.scene import SceneGraph as JGraph
from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.convert import (
    camera_from_numpy,
    lights_from_numpy,
    sphere_scene_from_numpy,
    tape_from_numpy,
)
from csgrenderer_tpu_torch.io import read_png
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import tape_kernel as tk
from csgrenderer_tpu_torch.models import config3_csg_scene, csg_night_scene, night_scene
from csgrenderer_tpu_torch.render import lights as tl
from csgrenderer_tpu_torch.render import render_image, tape_hit_adapter

REPO = Path(__file__).resolve().parent.parent
SCENE_FIELDS = ("centers", "radii", "mat_kind", "albedo", "mat_param")
CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v", "lens_radius")
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


def port_camera(jcam):
    return camera_from_numpy(*(np.asarray(getattr(jcam, f)) for f in CAM_FIELDS))


def port_scene(jscene):
    return sphere_scene_from_numpy(*(np.asarray(getattr(jscene, f)) for f in SCENE_FIELDS))


def port_tape(jtape):
    return tape_from_numpy(*(getattr(jtape, f) for f in STATIC),
                           *(np.asarray(getattr(jtape, f)) for f in ARRAYS))


def night_cam(aspect=2.0):
    return Camera.look_at((6.5, 2.2, 6.5), (0.0, 0.6, 0.0), vfov_degrees=32.0, aspect_ratio=aspect)


def csg_night_cam(aspect=2.0):
    return Camera.look_at((4.5, 2.6, 4.8), (0.0, 0.8, 0.3), vfov_degrees=38.0, aspect_ratio=aspect)


def test_render_image_lights_matches_jax():
    """The port's integrator with lights= against JAX's, on tests/test_nee.py's
    small scene at its 48x48, 8 spp, 5 bounces, lights carried across with
    lights_from_numpy."""
    kw = dict(width=48, height=48, spp=8, max_bounces=5, seed=2, sky="black")
    jscene = j_small_scene()
    jcam = JCamera.look_at((0, 0.6, 2.0), (0, 0, -1), vfov_degrees=50.0, aspect_ratio=1.0)
    jlights = jl.extract_lights(jscene)
    with jax.disable_jit():
        ref, ref_rays = j_integrator.render_image(jscene.nearest_hit, jcam, lights=jlights, **kw)
    scene = port_scene(jscene)
    lights = lights_from_numpy(*(np.asarray(f) for f in jlights))
    img, rays = render_image(scene.nearest_hit, port_camera(jcam), lights=lights, **kw)
    rmse = float(np.sqrt(np.mean((np.asarray(ref) - img.numpy()) ** 2)))
    assert rmse < 1e-4, rmse
    assert int(rays) == int(ref_rays)
    assert float(img.mean()) > 0.05  # lit by the lamp alone (black sky)


def test_tape_nee_matches_jax():
    """small_csg_night_tape through tape_hit_adapter with lights= at
    48x24, 3 spp, 4 bounces (tests/test_nee.py::test_tape_kernel_nee_matches_jnp's
    frame and bound)."""
    kw = dict(width=48, height=24, spp=3, max_bounces=4, seed=7, sky="black")
    jtape = j_small_csg_night_tape()
    jcam = JCamera.look_at((0, 2.0, 2.5), (0.3, 1.0, -2.5), vfov_degrees=50.0, aspect_ratio=2.0)
    with jax.disable_jit():
        ref, ref_rays = j_integrator.render_image(
            functools.partial(j_integrator.tape_hit_adapter, jtape), jcam,
            lights=jl.extract_tape_lights(jtape), **kw)
    tape = port_tape(jtape)
    img, rays = render_image(functools.partial(tape_hit_adapter, tape), port_camera(jcam),
                             lights=tl.extract_tape_lights(tape), **kw)
    bad = float((np.abs(img.numpy() - np.asarray(ref)).max(axis=-1) > 0.05).mean())
    assert bad <= 0.01, f"{bad:.3%} divergent"
    assert int(rays) == int(ref_rays)
    # the tape kernel's plain version (event flips) renders the same lamps
    kimg, krays = tk.render_image_tape_kernel(tape, port_camera(jcam), nee=True, **kw)
    kbad = float(((kimg - img).abs().amax(dim=-1) > 0.05).float().mean())
    assert kbad <= 0.01 and int(krays) == int(rays)


def test_night_scenes_byte_identical():
    """night_scene at both sizes, and the csg_night_scene tape (its box
    rotation is from_axis_angle of 0.6 in float32), bit for bit as the JAX
    scene functions make them."""
    from csgrenderer_tpu.models import csg_night_scene as j_csg_night

    for grid in (6, 11):
        a, b = j_night(grid=grid), night_scene(grid=grid)
        for f in SCENE_FIELDS:
            assert getattr(b, f).numpy().tobytes() == np.asarray(getattr(a, f)).tobytes(), f
    assert night_scene().num_spheres == 148 and night_scene(grid=11).num_spheres == 488
    ja, pa = j_csg_night().compile(k=4), csg_night_scene().compile(k=4)
    for f in STATIC:
        assert getattr(pa, f) == getattr(ja, f), f
    for f in ARRAYS:
        assert getattr(pa, f).numpy().tobytes() == np.asarray(getattr(ja, f)).tobytes(), f


def test_lamp_table_matches_jax_packer():
    """The sphere kernel's [n_lights, 8] lamp rows as the JAX packer builds
    them after pack_grid's reorder (megakernel.py:899-906): ids in the
    kernel's id space."""
    jscene = j_night(grid=11)
    jpack, jreordered = j_pack_grid(jscene)
    jlights, jids = jl.extract_lights(jreordered, return_ids=True)
    packed = mk.pack_scene(night_scene(grid=11))
    assert packed.mode == "grid" and packed.grid.n_globals == jpack.n_globals
    want = np.zeros((len(jids), 8), np.float32)
    want[:, 0:3], want[:, 3], want[:, 4:7] = jlights.centers, jlights.radii, jlights.emit
    want[:, 7] = jids
    np.testing.assert_array_equal(packed.lamps.numpy(), want)
    kinds = packed.scene.mat_kind[packed.lamps[:, 7].long()]
    assert bool((kinds == 4).all())
    assert mk.pack_scene(night_scene(), False).lamps.shape == (2, 8)


@pytest.mark.parametrize("worklist", [False, True])
def test_sphere_kernel_nee_on_cpu_equals_plain(worklist):
    """render_image_kernel(nee=True) on CPU tensors is its plain version
    with the packed lamps, both modes (grid forced on the griddable 148-sphere
    scene), and both modes render the same image as the reference's brute
    nearest hit with extract_lights."""
    scene, cam = night_scene(), night_cam()
    kw = dict(width=32, height=16, spp=2, max_bounces=4, seed=3, sky="black")
    packed = mk.pack_scene(scene, worklist)
    assert packed.mode == ("grid" if worklist else "brute")
    before = (mk.LAUNCHES, dict(mk.LAUNCHES_BY_MODE))
    img, rays = mk.render_image_kernel(packed, cam, nee=True, **kw)
    assert (mk.LAUNCHES, dict(mk.LAUNCHES_BY_MODE)) == before  # CPU tensors never launch
    ref, ref_rays = mk.render_image_plain(packed, cam, nee=True, **kw)
    assert torch.equal(img, ref) and int(rays) == int(ref_rays)
    direct, d_rays = render_image(scene.nearest_hit, cam, lights=tl.extract_lights(scene), **kw)
    assert torch.equal(img, direct) and int(rays) == int(d_rays)
    plain, _ = mk.render_image_kernel(packed, cam, **kw)
    assert not torch.equal(plain, img)  # NEE changes the estimate


def test_tape_kernel_nee_on_cpu_equals_plain():
    """render_image_tape_kernel(nee=True) on CPU tensors is its plain
    version; clustered and global evaluation give the same image; the
    lamps are read from the leaf table as extract_tape_lights gives them."""
    tape, cam = csg_night_scene().compile(k=4), csg_night_cam()
    kw = dict(width=32, height=16, spp=2, max_bounces=4, seed=3, sky="black")
    clustered = tk.pack_program(tape)
    assert clustered.mode == "clustered"
    want = tl.extract_tape_lights(tape)
    for a, b in zip(clustered.lights, want):
        assert torch.equal(a, b)
    img, rays = tk.render_image_tape_kernel(clustered, cam, nee=True, **kw)
    ref, ref_rays = tk.render_image_tape_plain(clustered, cam, nee=True, **kw)
    assert torch.equal(img, ref) and int(rays) == int(ref_rays)
    glob, g_rays = tk.render_image_tape_kernel(tape, cam, nee=True, partition=False, **kw)
    np.testing.assert_allclose(glob.numpy(), img.numpy(), atol=1e-5)
    assert int(g_rays) == int(rays)


def test_counts_of_nee_work():
    """integrator counts: every traced shadow ray comes from a lamp sample,
    every clear one from a traced one, and the sums do not change the image."""
    packed, cam = mk.pack_scene(night_scene()), night_cam()
    kw = dict(width=24, height=12, spp=1, max_bounces=4, seed=1, sky="black", nee=True)
    counts = {}
    img, rays = mk.render_image_plain(packed, cam, counts=counts, **kw)
    c = {k: int(v) for k, v in counts.items()}
    assert set(c) == {"nee_vertices", "shadow_rays", "shadow_clear", "mis_emission", "carried_pdfs"}
    assert 0 < c["shadow_clear"] <= c["shadow_rays"] <= c["nee_vertices"] < int(rays)
    assert c["carried_pdfs"] <= c["nee_vertices"]
    assert torch.equal(img, mk.render_image_plain(packed, cam, **kw)[0])


def _blocker_scene(rng, radius):
    """tests/test_nee.py::test_grid_shadow_segment_occlusion_semantics's scene."""
    centers = [[0.0, -1000.0, 0.0], [0.0, 4.0, 0.0], [0.0, 2.0, 0.0]]
    radii, kinds = [1000.0, 0.5, radius], [1, 4, 1]
    albs, prms = [[0.7, 0.7, 0.7], [20.0, 20.0, 20.0], [0.1, 0.1, 0.1]], [0.0, 0.0, 0.0]
    for k in range(60):  # a filler ring far from the shadow axis, so the scene grids
        ang = 2 * np.pi * k / 60
        centers.append([6.0 * np.cos(ang), 0.2, 6.0 * np.sin(ang)])
        radii.append(0.2)
        kinds.append(1)
        albs.append(rng.random(3).tolist())
        prms.append(0.0)
    return sphere_scene_from_numpy(centers, radii, kinds, albs, prms)


def test_blocker_umbra_on_the_plain_grid_path():
    """A blocker between the lamp and the floor darkens the floor below it
    through the grid walk's shadow rays; removing it restores the light."""
    rng = np.random.default_rng(11)
    cam = Camera.look_at((0.0, 3.0, 6.0), (0.0, 0.0, 0.0), vfov_degrees=40.0, aspect_ratio=1.0)
    imgs = {}
    for name, radius in (("blocked", 0.8), ("open", 1e-4)):
        packed = mk.pack_scene(_blocker_scene(rng, radius), True)
        assert packed.mode == "grid"
        imgs[name], _ = mk.render_image_kernel(packed, cam, 32, 32, spp=8, max_bounces=3, seed=4,
                                               sky="black", nee=True)
    c = slice(12, 20)
    assert float(imgs["blocked"][c, c].mean()) < 0.25 * float(imgs["open"][c, c].mean())


def test_nee_without_an_emitter_raises():
    scene = sphere_scene_from_numpy([[0, 0, -1], [0, -100.5, -1]], [0.5, 100], [1, 1],
                                    [[0.5] * 3, [0.5] * 3], [0.0, 0.0])
    cam = night_cam()
    with pytest.raises(ValueError, match="emissive"):
        mk.render_image_kernel(scene, cam, 8, 4, nee=True)
    packed = mk.pack_scene(scene)
    assert packed.lamps is None and packed.lights is None
    with pytest.raises(ValueError, match="emissive"):
        mk.render_image_plain(packed, cam, 8, 4, nee=True)
    tape = config3_csg_scene().compile(k=2)
    with pytest.raises(ValueError, match="emissive"):
        tk.render_image_tape_kernel(tape, cam, 8, 4, nee=True)
    with pytest.raises(ValueError, match="emissive"):
        tk.render_image_tape_plain(tk.pack_program(tape), cam, 8, 4, nee=True)


def test_cli_renders_csgnight(tmp_path):
    out = tmp_path / "csgnight.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs in several workers at once
    proc = subprocess.run(
        [sys.executable, "-m", "csgrenderer_tpu_torch", "render", "--scene", "csgnight",
         "--width", "24", "--height", "16", "--spp", "1", "--bounces", "3", "--device", "cpu",
         "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = read_png(out)
    assert img.shape == (16, 24, 3) and img.std() > 0
