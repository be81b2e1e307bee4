"""`BENCHMARK.json` and the files it names: configurations, traffic mixes,
limits. Everything is found by name."""

from __future__ import annotations

import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str) -> dict:
    for c in benchmark()["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """A configuration by name: the file `BENCHMARK.json` gives it, else
    `configs/<name>.json` (a configuration no cell uses yet)."""
    for c in benchmark()["configs"]:
        if c["name"] == name:
            return _load(os.path.relpath(os.path.join(ROOT, c["file"]), HERE))
    return _load("configs", name + ".json")


def traffic(name: str) -> dict:
    return _load("traffic", name + ".json")


def metric_units() -> Dict[str, str]:
    b = benchmark()
    return {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}


def per_layer(cell_name: str):
    """The per-layer metrics a cell reports: those that list it, or list no
    cells and move one of its end-to-end metrics."""
    b = benchmark()
    e2e = {m["name"] for m in b["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in b["per_layer"]:
        listed = cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e
        if listed:
            out.append(m["name"])
    return out
