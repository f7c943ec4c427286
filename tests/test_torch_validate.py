"""``tools/validate_gpu.py``, the converged-image protocol of the port, on
the CPU at tiny sizes: the protocol end to end with the plain path on both
sides, ``_chunked`` against one call, the mesh scenes of configs 6-10
against demo 7's, ``pack_tri_grid(cell=)``, which config 10's second grid
uses, and config 11's denoise protocol at a small size. On the card the
tool holds the CUDA kernels to the plain path (``chip_smoke.py`` runs
configs 1, 2 and 11; PERF.md has the others).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from csgrenderer_tpu_torch.camera import Camera
from csgrenderer_tpu_torch.kernels import megakernel as mk
from csgrenderer_tpu_torch.kernels import tri_worklist as twl
from csgrenderer_tpu_torch.kernels import trimesh_kernel as tm
from csgrenderer_tpu_torch.models import mesh_demo_scene, two_spheres_scene
from csgrenderer_tpu_torch.tools import validate_gpu as vg

from test_torch_trimesh import assert_same_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_config(spp0=2, max_spp=8):
    cam = Camera.look_at((0, 0, 0), (0, 0, -1), vfov_degrees=90, aspect_ratio=12 / 8)
    kernel, reference = vg._pair(mk.render_image_kernel, mk.render_image_plain,
                                 mk.pack_scene(two_spheres_scene()), cam, 12, 8, 4)
    return vg.Config("tiny_two_spheres", kernel, reference, spp0, max_spp, chunk=3)


def test_protocol_end_to_end_on_the_cpu(capsys):
    """Noise certificate and fidelity on a tiny two-sphere frame, the plain
    version on both sides: spp doubles to max_spp (the noise of 8 spp is
    far above 3e-4), the same-seed RMSE is 0, and the config fails only
    for its noise."""
    res = vg.validate_converged(_tiny_config())
    out = capsys.readouterr().out
    assert "spp=2 noise=" in out and "spp=4 noise=" in out and "spp=8 noise=" in out
    assert res["spp"] == 8 and res["rmse"] == 0.0 and res["noise"] > vg.NOISE_BUDGET
    assert not res["ok"] and "FAIL" in out


def test_main_runs_config1_and_refuses_cuda_without_it(capsys, monkeypatch):
    """The entry point: config 1 (the milestone-01 frame, 320x240) against
    its golden on the CPU; "config1" selects config 1 alone; config 11 is
    ported and selectable ("config11" alone; its protocol is stubbed here,
    test_config11_protocol_on_the_cpu runs it small); a selector that
    names no config exits."""
    assert vg.main(["--device", "cpu", "--only", "config1"]) == 0
    out = capsys.readouterr().out
    assert "config1_milestone01: deterministic" in out and "OK" in out
    assert "1 of 1 configs" in out and "config10" not in out and "config11" not in out
    assert not hasattr(vg, "NOT_PORTED")
    ran = []
    monkeypatch.setattr(vg, "validate_denoise", lambda device: ran.append(device) or dict(
        name="config11_denoise2spp", ok=True))
    assert vg.main(["--device", "cpu", "--only", "config11"]) == 0
    assert ran == [torch.device("cpu")] and "1 of 1 configs" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            vg.main(["--only", "config1"])
    with pytest.raises(SystemExit, match="selects no config"):
        vg.main(["--device", "cpu", "--only", "config12"])


def test_config11_protocol_on_the_cpu(capsys):
    """Config 11's protocol at 32x18 with the plain version on the CPU (the
    card runs it at 128x72 against 4,096 spp): the denoised frame is
    closer to the converged one than the raw frame, and the verdict
    applies the two bounds."""
    res = vg.validate_denoise(torch.device("cpu"), size=(32, 18), converged_spp=128, chunk=64)
    out = capsys.readouterr().out
    assert "config11_denoise2spp: rmse_raw=" in out and "converged 128 spp" in out
    assert res["name"] == "config11_denoise2spp"
    assert 0 < res["rmse_den"] < res["rmse_raw"]
    assert res["ok"] == (res["rmse_den"] < vg.DENOISE_RATIO * res["rmse_raw"]
                         and res["rmse_den"] <= vg.DENOISE_BUDGET)


def test_chunked_equals_one_call():
    """Accumulating 7 spp over calls of 3 at disjoint sample offsets gives
    the 7-spp image within float32 rounding (counter-based RNG)."""
    cfg = _tiny_config()
    one = vg._chunked(cfg.reference, 11, 7, 7)
    parts = vg._chunked(cfg.reference, 11, 7, 3)
    np.testing.assert_allclose(parts, one, rtol=0, atol=2e-6 * max(1.0, float(np.abs(one).max())))
    assert not np.array_equal(vg._chunked(cfg.reference, 12, 7, 3), parts)


@pytest.mark.parametrize("subdiv", [2, 3, 4, 6])
def test_mesh_scenes_are_demo7s(subdiv):
    """Configs 6, 9, 8 and 10 render mesh_demo_scene(2, 3, 4, 6): demo 7's
    scene (read, not edited), face for face."""
    sys.path.insert(0, str(REPO / "demos"))
    try:
        from demo7_mesh import build_scene
    finally:
        sys.path.remove(str(REPO / "demos"))
    assert_same_mesh(mesh_demo_scene(subdiv), build_scene(subdiv=subdiv))


def test_pack_tri_grid_cell():
    """An explicit cell bins every face into every voxel it touches: a
    grid of twice the rule's cell finds the same nearest hits; None keeps
    the occupancy rule; a cell too fine for MAX_VOXELS raises."""
    mesh = mesh_demo_scene(2)
    rule = twl.pack_tri_grid(mesh)
    assert twl.pack_tri_grid(mesh, None).static == rule.static
    coarse = twl.pack_tri_grid(mesh, 2.0 * rule.static.cell)
    assert coarse.static.cell == 2.0 * rule.static.cell
    assert all(c < r for c, r in zip(coarse.static.dims, rule.static.dims))
    assert tm.pack_mesh(mesh, True, cell=2.0 * rule.static.cell).grid.static == coarse.static
    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.tile([[0.0, 1.6, 2.2]], (4096, 1)).astype(np.float32))
    d = torch.from_numpy((rng.normal(size=(4096, 3)) * [1.0, 0.3, 1.0] + [0, -0.2, -1])
                         .astype(np.float32))
    t_a, i_a, h_a = twl.tri_grid_nearest_hit(rule, mesh, o, d)
    t_b, i_b, h_b = twl.tri_grid_nearest_hit(coarse, mesh, o, d)
    assert int(h_a.sum()) > 1000
    assert torch.equal(h_a, h_b) and torch.equal(t_a, t_b) and torch.equal(i_a[h_a], i_b[h_b])
    with pytest.raises(ValueError, match="voxels"):
        twl.pack_tri_grid(mesh, 1e-4)
