"""BENCHMARK.json and the files the harness finds by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests.rehearsal import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).is_file()
        names.append(c["name"])
    assert {w["config"] for w in SPEC["workloads"]} == set(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for x in [c["name"] for c in SPEC["configs"]] + CELLS + [
            m["name"] for m in metrics]:
        assert NAME.match(x), x
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    found = harness.find_cell(SPEC, cell)
    assert found["cell"]["config"] == found["entry"]["config"]
    assert harness.traffic_class(found["cell"]["kind"]) is not None
    e2e = {m["name"] for m in found["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert found["per_layer"]
    for m in found["per_layer"]:
        # a per-layer metric moves an end-to-end metric its cells report
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert "workloads" in m and set(m["workloads"]) <= set(CELLS)
    perf = (REPO / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        # the layer as PERF.md's list of layers names it
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_a_new_cell_file_is_found_without_editing_any_file(tmp_path):
    """A later PR adds a cell by adding files and BENCHMARK.json entries."""
    root = tmp_path / "root"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "ldb_1080.enc_long",
                              "config": "ldb_1080", "traffic": "enc_long",
                              "chips": 1, "why": "more clips"})
    for m in spec["end_to_end"]:
        if m["name"] == "encode_fps":
            m["workloads"].append("ldb_1080.enc_long")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "workloads" / "ldb_1080.enc_long.json").write_text(
        json.dumps({"config": "ldb_1080", "traffic": "enc_long",
                    "kind": "encode_live",
                    "params": {"nominal_fps": 1.6, "bank": 12,
                               "warm_frames": 17}}))
    found = harness.find_cell(harness.benchmark_spec(root),
                              "ldb_1080.enc_long", root / "benchmark")
    assert found["cell"]["params"]["bank"] == 12
    assert {m["name"] for m in found["end_to_end"]} == {"encode_fps",
                                                        "setup_s"}
    # no per-layer metric lists it: none is asked of it
    assert found["per_layer"] == []
    t = harness.traffic_class(found["cell"]["kind"])(
        root, found["config"], found["cell"]["params"], 1, None)
    assert t.window_clips(30) == 3 and t.bank == 12


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"][0]["traffic"] = "other"
    with pytest.raises(harness.CellError):
        harness.find_cell(spec, spec["workloads"][0]["name"])
