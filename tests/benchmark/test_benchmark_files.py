"""Cells, configurations, traffic mixes and metrics are files found by name:
the repository's own, and new ones added beside them without an edit."""

import json
import re
import shutil

import benchmark_cpu
import pytest
import torch

from benchmark import harness

REPO = benchmark_cpu.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    run = harness.find(cell, seed=1, seconds=1.0, trace=False, device=torch.device("cpu"),
                       t_start=0.0)
    assert run.config["name"] == run.entry["config"]
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(run.driver, fn))
    for fn in ("program_scene", "reference_scene", "work"):
        assert callable(getattr(run.config_module, fn))
    assert set(run.cell["limits"]) and all(v >= 0 for v in run.cell["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    mod = harness.load_module(REPO / "benchmark" / "metrics" / f"{metric}.py", "t_" + metric)
    assert callable(mod.read)


def test_the_spec_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert (REPO / p).is_dir() and re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["reduced"] == []
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        reported = {m["name"] for m in harness.metrics_for(SPEC, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_for(SPEC, w["name"], True)
        assert layer and all(m["moves"] in reported for m in layer)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)


def test_a_new_cell_configuration_mix_and_metric_are_found_as_files(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(REPO / "benchmark", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((root / "configs" / "rtiow_final.json").read_text())
    cfg["name"] = "rtiow_copy"
    (root / "configs" / "rtiow_copy.json").write_text(json.dumps(cfg))
    shutil.copy(root / "configs" / "rtiow_final.py", root / "configs" / "rtiow_copy.py")
    (root / "traffic" / "offline-tiny.json").write_text(json.dumps(
        {"driver": "offline_progressive", "width": 24, "height": 12, "spp": 1, "animate": False,
         "warm_frames": 1}))
    (root / "workloads" / "rtiow-copy-tiny.json").write_text(json.dumps(
        {"config": "rtiow_copy", "traffic": "offline-tiny",
         "check": {"rows": 4},
         "limits": {"divergent_share": 0.0, "image_share": 0.0, "rays_gap": 0.0,
                    "samples_gap": 0}}))
    (root / "metrics" / "frames_completed.py").write_text(
        "def read(run):\n    return len(run.frames) or None\n")
    spec["configs"].append({**spec["configs"][0], "name": "rtiow_copy"})
    spec["workloads"].append({"name": "rtiow-copy-tiny", "config": "rtiow_copy",
                              "traffic": "offline-tiny", "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "frames_completed", "unit": "frames", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["rtiow-copy-tiny"]})
    run = harness.find("rtiow-copy-tiny", root=root, spec=spec, seed=3, seconds=0.05,
                       trace=False, device=torch.device("cpu"), t_start=0.0)
    assert run.config["name"] == "rtiow_copy" and run.mix["width"] == 24
    harness.execute(run)
    line = harness.result(run)
    assert line["correct"] is True
    assert line["metrics"]["frames_completed"]["value"] == len(run.frames) >= 1
    assert set(line["metrics"]) == {"setup_s", "frames_completed"}
