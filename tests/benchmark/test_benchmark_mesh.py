"""The triangle-mesh cell, ``mesh-720p16``: its files are found by name, its
two per-layer metrics are its own, a tiny run of it (the scene cut to
subdivision 2 on the run's configuration) is correct and records the
frames' triangle tests, planted faults make it incorrect, a program that
counts no triangle tests is refused at set-up, the lower-precision control
fails a limit, and the mesh floor adds a fixed count of operations a hit."""

import json

import benchmark_cpu
import pytest
import torch
from test_benchmark_faults import answer_altered, half_batch, rays_inflated, state_unchanged

from benchmark import devicetrace, harness, roofline, roofline_mesh
from csgrenderer_tpu_torch.app import renderers

CELL = "mesh-720p16"
TINY = {"width": 32, "height": 18, "spp": 2, "warm_frames": 1}
SUBDIV = 2  # 5 x 320 + 2 = 1,602 faces: a tiny run stays well under half a minute
NEW_METRICS = {"roofline_share.mesh", "tri_tests_per_segment.mesh"}
SPEC = json.loads((benchmark_cpu.REPO / "BENCHMARK.json").read_text())


def find(seed: int = benchmark_cpu.SEED, seconds: float = 0.3):
    """The cell's Run at its tiny size, its scene cut to ``SUBDIV``."""
    run = harness.find(CELL, spec=benchmark_cpu.spec(), mix_overrides=TINY, seed=seed,
                       seconds=seconds, trace=False, device=torch.device("cpu"), t_start=0.0)
    scene = run.config["scene"]
    run.config["scene"] = {**scene, "subdiv": SUBDIV,
                           "faces": len(scene["spheres"]) * 20 * 4 ** SUBDIV + 2}
    return run


def tiny_run(seed: int = benchmark_cpu.SEED):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = find(seed)
        harness.execute(run)
    finally:
        torch.set_num_threads(threads)
    return run


def test_the_cell_finds_its_files():
    run = harness.find(CELL, seed=1, seconds=1.0, trace=False, device=torch.device("cpu"),
                       t_start=0.0)
    assert run.entry["chips"] == 1
    assert run.mix == {"driver": "offline_mesh", "width": 1280, "height": 720, "spp": 16,
                       "animate": False, "warm_frames": 3}
    assert run.config["nee"] is False and run.config["sky"] == "rtiow"
    assert run.config["bounces"] == 6 and run.config["reduced"] == []
    assert run.work() == {"faces": 102402, "objects": 6, "global_faces": 2}
    assert run.config["scene"]["faces"] == 102402
    assert set(run.cell["limits"]) == {"divergent_share", "image_share", "rays_gap",
                                       "samples_gap"}
    assert run.cell["check"]["rows"] == 16


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_new_metrics_are_the_mesh_cells_alone(cell):
    layer = {m["name"] for m in harness.metrics_for(SPEC, cell, True)}
    assert (layer & NEW_METRICS) == (NEW_METRICS if cell == CELL else set())
    if cell == CELL:
        e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
        assert layer == NEW_METRICS and e2e == {"mrays_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [benchmark_cpu.SEED, 7])
def test_a_tiny_run_is_correct_and_records_the_triangle_tests(seed):
    run = tiny_run(seed)
    line = json.loads(json.dumps(harness.result(run)))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"mrays_per_s", "setup_s"}
    assert line["checks"]["rays_gap"]["value"] == 0.0
    tests = run.facts["tri_tests"]
    assert len(tests) == len(run.frames) >= 1
    # every segment tests the floor's two global faces, and the walk lists more
    assert all(t > 2 * r for t, (_, r) in zip(tests, run.frames))


FAULTS = (state_unchanged, half_batch, answer_altered, rays_inflated)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    line = harness.result(tiny_run())
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_triangle_count_is_refused_at_set_up(monkeypatch):
    orig = renderers.PathTraceRenderer.__init__

    def without(self, *args, **kw):
        orig(self, *args, **kw)
        del self.last_frame_tri_tests

    monkeypatch.setattr(renderers.PathTraceRenderer, "__init__", without)
    run = find(seconds=0.1)
    with pytest.raises(RuntimeError, match="triangle tests"):
        run.driver.setup(run)
    assert not run.frames and "tri_tests" not in run.facts


def test_the_lower_precision_control_fails_a_limit():
    run = tiny_run()
    limits = run.cell["limits"]
    control = run.driver.control(run, torch.bfloat16)
    assert set(control) == set(limits)
    assert any(control[k] > limits[k] for k in limits), control


def test_the_mesh_floor_adds_a_fixed_count_for_each_hit():
    ops = roofline.OPS
    segments, pixels, spp = 1000, 100, 2
    hits = segments - pixels * spp
    got, nbytes = roofline_mesh.mesh_frame(segments, pixels, spp, 102402)
    assert got == (segments * (ops["ray"] + ops["segment"]) + hits * (52 + 52)
                   + (segments - hits) * ops["miss"])
    assert nbytes == pixels * 12 + 102402 * 48
    # no walk, voxel or culling term: the face count enters only the bytes
    assert roofline_mesh.mesh_frame(segments, pixels, spp, 1602)[0] == got
    one_more, _ = roofline_mesh.mesh_frame(segments + 1, pixels, spp, 1602)
    assert one_more - got == ops["ray"] + ops["segment"] + 52 + 52


def test_the_readers_read_the_triangle_tests_and_nothing_without_them():
    run = tiny_run()
    readers = {m: harness.load_module(benchmark_cpu.REPO / "benchmark" / "metrics" / f"{m}.py",
                                      "t_" + m.replace(".", "_")) for m in NEW_METRICS}
    per_segment = readers["tri_tests_per_segment.mesh"].read(run)
    assert per_segment == pytest.approx(sum(run.facts["tri_tests"])
                                        / sum(r for _, r in run.frames))
    assert readers["roofline_share.mesh"].read(run) is None  # untraced: no device time
    run.summary = devicetrace.Summary(window_s=2.0, busy_s=1.5, device_s={
        "void (anonymous namespace)::trimesh_kernel<true, false, false>(Params)": 1.0})
    pixels, faces = TINY["width"] * TINY["height"], run.work()["faces"]
    floor = sum(roofline.floor_seconds(*roofline_mesh.mesh_frame(r, pixels, TINY["spp"], faces))[0]
                for _, r in run.frames)
    assert readers["roofline_share.mesh"].read(run) == pytest.approx(100.0 * floor)
    del run.facts["tri_tests"]  # a program that counts no triangle tests reads none back
    assert readers["tri_tests_per_segment.mesh"].read(run) is None
