"""The lamp-lit NEE cell, ``night-nee-540p64``: its files are found by name,
its three per-layer metrics are its own, a tiny run of it is correct and
checks the shadow rays, planted faults (the shadow count among them) make
it incorrect, a program that counts no shadow rays is refused at once, and
the NEE floor adds a fixed count of operations a shadow ray."""

import json

import benchmark_cpu
import pytest
import torch
from test_benchmark_faults import answer_altered, half_batch, rays_inflated, state_unchanged

from benchmark import devicetrace, harness, roofline, roofline_nee
from csgrenderer_tpu_torch.app import renderers

CELL = "night-nee-540p64"
TINY = {"width": 32, "height": 18, "spp": 2, "warm_frames": 1}
NEW_METRICS = {"roofline_share.sphere_nee", "shadow_mrays_per_s.nee", "device_idle_share.nee"}
SPEC = json.loads((benchmark_cpu.REPO / "BENCHMARK.json").read_text())


def tiny_run(seed: int = benchmark_cpu.SEED):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = harness.find(CELL, spec=benchmark_cpu.spec(), mix_overrides=TINY, seed=seed,
                           seconds=0.3, trace=False, device=torch.device("cpu"),
                           t_start=0.0)
        harness.execute(run)
    finally:
        torch.set_num_threads(threads)
    return run


def test_the_cell_finds_its_files():
    run = harness.find(CELL, seed=1, seconds=1.0, trace=False, device=torch.device("cpu"),
                       t_start=0.0)
    assert run.entry["chips"] == 1
    assert run.mix == {"driver": "offline_nee", "width": 960, "height": 540, "spp": 64,
                       "animate": False, "warm_frames": 3}
    assert run.config["nee"] is True and run.config["sky"] == "black"
    assert run.work() == {"primitives": 488, "lamps": 2}
    assert set(run.cell["limits"]) == {"divergent_share", "image_share", "rays_gap",
                                       "samples_gap", "shadow_gap"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_new_metrics_are_the_nee_cells_alone(cell):
    layer = {m["name"] for m in harness.metrics_for(SPEC, cell, True)}
    assert (layer & NEW_METRICS) == (NEW_METRICS if cell == CELL else set())
    e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
    assert ("mrays_per_s" in e2e) == (cell != "rtiow-realtime-denoised-720p2")
    if cell == CELL:
        assert layer == NEW_METRICS and e2e == {"mrays_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [benchmark_cpu.SEED, 7])
def test_a_tiny_run_is_correct_and_checks_the_shadow_rays(seed):
    run = tiny_run(seed)
    line = json.loads(json.dumps(harness.result(run)))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"mrays_per_s", "setup_s"}
    assert line["checks"]["shadow_gap"]["value"] == 0.0
    shadows = run.facts["shadow_rays"]
    assert len(shadows) == len(run.frames) >= 1 and all(s > 0 for s in shadows)


def shadow_inflated(mp):
    """The shadow-ray count altered where the renderer takes it."""
    orig = renderers._render_kernel

    def inflated(*args, counts=None, **kw):
        out = orig(*args, counts=counts, **kw)
        if counts is not None:
            counts["shadow_rays"] = counts["shadow_rays"] + counts["shadow_rays"] // 50 + 1
        return out

    mp.setattr(renderers, "_render_kernel", inflated)


FAULTS = (state_unchanged, half_batch, answer_altered, rays_inflated, shadow_inflated)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    line = harness.result(tiny_run())
    assert line["correct"] is False, line["checks"]


def test_a_program_without_the_shadow_count_is_refused_at_set_up(monkeypatch):
    orig = renderers.PathTraceRenderer.__init__

    def without(self, *args, **kw):
        orig(self, *args, **kw)
        del self.last_frame_shadow_rays

    monkeypatch.setattr(renderers.PathTraceRenderer, "__init__", without)
    run = harness.find(CELL, spec=benchmark_cpu.spec(), mix_overrides=TINY, seed=1, seconds=0.1,
                       trace=False, device=torch.device("cpu"), t_start=0.0)
    with pytest.raises(RuntimeError, match="shadow rays"):
        run.driver.setup(run)
    assert not run.frames


def test_the_nee_floor_adds_its_operations_for_each_shadow_ray():
    assert roofline_nee.SHADOW_RAY == 134
    base, nbytes = roofline.sphere_frame(1000, 100, 2, 488, "black")
    ops, with_lamps = roofline_nee.nee_frame(1000, 300, 100, 2, 488, 2, "black")
    assert ops == base + 300 * 134 and with_lamps == nbytes + 2 * 32
    # the grid walk of the shadow ray, like the path ray's, is no part of it
    assert roofline_nee.nee_frame(1000, 300, 100, 2, 6402, 2)[0] == ops


def test_the_readers_read_the_shadow_counts_and_nothing_without_them():
    run = tiny_run()
    readers = {m: harness.load_module(benchmark_cpu.REPO / "benchmark" / "metrics" / f"{m}.py",
                                      "t_" + m.replace(".", "_")) for m in NEW_METRICS}
    shadow_rate = readers["shadow_mrays_per_s.nee"].read(run)
    assert shadow_rate == pytest.approx(sum(run.facts["shadow_rays"]) / run.window_s / 1e6)
    assert readers["roofline_share.sphere_nee"].read(run) is None  # untraced: no device time
    run.summary = devicetrace.Summary(window_s=2.0, busy_s=1.5,
                                      device_s={"void sphere_megakernel<true, true, true>": 1.0})
    pixels, work = TINY["width"] * TINY["height"], run.work()
    floor = sum(roofline.floor_seconds(*roofline_nee.nee_frame(
        r, s, pixels, TINY["spp"], work["primitives"], work["lamps"]))[0]
        for (_, r), s in zip(run.frames, run.facts["shadow_rays"]))
    assert readers["roofline_share.sphere_nee"].read(run) == pytest.approx(100.0 * floor)
    assert readers["device_idle_share.nee"].read(run) == pytest.approx(25.0)
    del run.facts["shadow_rays"]  # a program that counts no shadow rays reads none back
    assert readers["shadow_mrays_per_s.nee"].read(run) is None
    assert readers["roofline_share.sphere_nee"].read(run) is None
