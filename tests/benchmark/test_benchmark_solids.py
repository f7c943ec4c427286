"""The many-solids cell, ``manyobjects-720p16``: its files are found by name,
its two per-layer metrics are its own, a tiny run of it (the scene cut on
the run's configuration to its first 8 objects and the ground) is correct
and records one leaf-interval count a frame, leaves x segments, planted
faults make it incorrect, a program that counts no leaf intervals is
refused at set-up, the lower-precision control fails a limit, and the
solids floor adds a fixed count of operations a hit, whatever the leaf
count."""

import json

import benchmark_cpu
import pytest
import torch
from test_benchmark_faults import answer_altered, half_batch, rays_inflated, state_unchanged

from benchmark import devicetrace, harness, roofline, roofline_solids
from csgrenderer_tpu_torch.app import renderers

CELL = "manyobjects-720p16"
TINY = {"width": 32, "height": 18, "spp": 2, "warm_frames": 1}
OBJECTS = 8  # 17 leaves: a tiny run stays within seconds
NEW_METRICS = {"leaf_tests_per_segment.solids", "roofline_share.solids"}
SPEC = json.loads((benchmark_cpu.REPO / "BENCHMARK.json").read_text())


def find(seed: int = benchmark_cpu.SEED, seconds: float = 0.3):
    """The cell's Run at its tiny size, its scene cut to ``OBJECTS`` objects."""
    run = harness.find(CELL, spec=benchmark_cpu.spec(), mix_overrides=TINY, seed=seed,
                       seconds=seconds, trace=False, device=torch.device("cpu"), t_start=0.0)
    scene = run.config["scene"]
    run.config["scene"] = {**scene, "objects": scene["objects"][:OBJECTS],
                           "leaves": 2 * OBJECTS + 1}
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


@pytest.fixture(scope="module")
def done():
    """One tiny run at the benchmark's seed, shared by the tests that only read it."""
    return tiny_run()


def test_the_cell_finds_its_files():
    run = harness.find(CELL, seed=1, seconds=1.0, trace=False, device=torch.device("cpu"),
                       t_start=0.0)
    assert run.entry["chips"] == 1
    assert run.mix == {"driver": "offline_solids", "width": 1280, "height": 720, "spp": 16,
                       "animate": False, "warm_frames": 3}
    assert run.config["nee"] is False and run.config["sky"] == "rtiow"
    assert run.config["bounces"] == 8 and run.config["reduced"] == []
    assert run.config["scene"]["k"] == 4 and run.config["scene"]["leaves"] == 199
    assert run.work() == {"leaves": 199, "objects": 99,
                          "leaf_types": ["sphere", "halfspace", "box", "cylinder"]}
    assert harness.camera(run.config, run.cell)["lookfrom"] == (0.0, 7.0, 9.0)
    assert run.cell["limits"] == {"divergent_share": 0.01, "image_share": 0.01,
                                  "rays_gap": 1e-4, "samples_gap": 0}
    assert run.cell["check"]["rows"] == 16


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_new_metrics_are_the_solids_cells_alone(cell):
    layer = {m["name"] for m in harness.metrics_for(SPEC, cell, True)}
    assert (layer & NEW_METRICS) == (NEW_METRICS if cell == CELL else set())
    if cell == CELL:
        e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
        assert layer == NEW_METRICS and e2e == {"mrays_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [benchmark_cpu.SEED, 7])
def test_a_tiny_run_is_correct_and_records_the_leaf_tests(seed, done):
    run = done if seed == benchmark_cpu.SEED else tiny_run(seed)
    line = json.loads(json.dumps(harness.result(run)))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"mrays_per_s", "setup_s"}
    assert line["checks"]["rays_gap"]["value"] == 0.0
    tests = run.facts["leaf_tests"]
    assert len(tests) == len(run.frames) >= 1
    assert all(t == (2 * OBJECTS + 1) * r for t, (_, r) in zip(tests, run.frames))


FAULTS = (state_unchanged, half_batch, answer_altered, rays_inflated)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    line = harness.result(tiny_run())
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_leaf_count_is_refused_at_set_up(monkeypatch):
    orig = renderers.PathTraceRenderer.__init__

    def without(self, *args, **kw):
        orig(self, *args, **kw)
        del self.last_frame_leaf_tests

    monkeypatch.setattr(renderers.PathTraceRenderer, "__init__", without)
    run = find(seconds=0.1)
    with pytest.raises(RuntimeError, match="leaf intervals"):
        run.driver.setup(run)
    assert not run.frames and "leaf_tests" not in run.facts


def test_the_lower_precision_control_fails_a_limit(done):
    limits = done.cell["limits"]
    control = done.driver.control(done, torch.bfloat16)
    assert set(control) == set(limits)
    assert any(control[k] > limits[k] for k in limits), control


def test_the_solids_floor_adds_a_fixed_count_for_each_hit():
    ops = roofline.OPS
    types = ["sphere", "halfspace", "box", "cylinder"]
    segments, pixels, spp = 1000, 100, 2
    hits = segments - pixels * spp
    got, nbytes = roofline_solids.solids_frame(segments, pixels, spp, 199, types)
    per_hit = ops["leaf_transform"] + 14 + 2 * ops["candidate_test"] + ops["tape_hit"] + 40
    assert got == (segments * (ops["ray"] + ops["segment"]) + hits * per_hit
                   + (segments - hits) * ops["miss"])
    assert nbytes == pixels * 12 + 199 * 64
    # no term per leaf, cluster or bound test: the leaf count enters only the bytes
    assert roofline_solids.solids_frame(segments, pixels, spp, 17, types)[0] == got
    # the cheapest leaf type present prices the one leaf a hit computes
    spheres, _ = roofline_solids.solids_frame(segments, pixels, spp, 8, ["sphere"])
    assert spheres - got == hits * (29 - 14 + 47 - 40)
    # below the every-leaf tape floor of the same frame
    assert got < roofline.tape_frame(segments, pixels, spp, 199)[0]


def test_the_readers_read_the_leaf_tests_and_nothing_without_them(done):
    readers = {m: harness.load_module(benchmark_cpu.REPO / "benchmark" / "metrics" / f"{m}.py",
                                      "t_" + m.replace(".", "_")) for m in NEW_METRICS}
    assert readers["leaf_tests_per_segment.solids"].read(done) == 2 * OBJECTS + 1
    assert readers["roofline_share.solids"].read(done) is None  # untraced: no device time
    summary = done.summary
    done.summary = devicetrace.Summary(window_s=2.0, busy_s=1.5, device_s={
        "void (anonymous namespace)::tape_kernel<false, false, 8>(Params)": 1.0})
    work, pixels = done.work(), TINY["width"] * TINY["height"]
    floor = sum(roofline.floor_seconds(*roofline_solids.solids_frame(
        r, pixels, TINY["spp"], work["leaves"], work["leaf_types"]))[0] for _, r in done.frames)
    try:
        assert readers["roofline_share.solids"].read(done) == pytest.approx(100.0 * floor)
    finally:
        done.summary = summary
    tests = done.facts.pop("leaf_tests")  # a program that counts no leaf intervals reads none
    try:
        assert readers["leaf_tests_per_segment.solids"].read(done) is None
    finally:
        done.facts["leaf_tests"] = tests
