"""BENCHMARK.json against the contract's rules, and every file it names."""

import json
import math
import os
import re
import statistics

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and B["run_seconds"] == int(B["run_seconds"])
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in B["paths"])
    assert len(json.dumps(B)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for c in B["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert c["chips"] == 1
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({n for _, n in names if _ == "workloads"}) == len(B["workloads"])


def test_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


def test_every_cell_reports_what_its_layers_move():
    cells = {c["name"] for c in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in cells:
        assert spec.per_layer(cell), cell
        assert any("workloads" not in m or cell in m["workloads"]
                   for m in B["end_to_end"] if m["name"] != "setup_s")


@pytest.mark.parametrize("cell", [c["name"] for c in B["workloads"]])
def test_cell_files_are_found_by_name(cell):
    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    assert cfg["name"] == c["config"]
    entry = next(e for e in B["configs"] if e["name"] == c["config"])
    assert entry["file"].startswith("benchmark/") and entry["reduced"] == cfg["reduced"]
    assert spec.traffic(c["traffic"])["entry"] in ("train",)
    lims = json.load(open(os.path.join(spec.HERE, "limits", cell + ".json")))["limits"]
    assert all(v > 0 and math.isfinite(v) for v in lims.values())
    for name in spec.per_layer(cell):
        assert os.path.exists(os.path.join(spec.HERE, "metrics", name + ".py")), name


def test_run_seconds_fit_a_full_check():
    # 2 + 14 runs per cell, each run_seconds + 60, 2 x 90 s compile per cell,
    # 1200 s spare, with all 24 cells
    cells = 24
    total = (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_median_helper_matches_statistics():
    assert statistics.median([3.0, 1.0, 2.0]) == 2.0
