"""Per-layer metrics: one reader per metric, in `metrics/<name>.py`, found by
the metric's name. A reader's `read(ctx)` returns the value, or None when it
finds nothing to read; the harness then leaves the metric out.

`ctx` holds what the traced run measured: `spans` (the benchmark's span
seconds by name), `profile` (``trace.profile``'s result over the profiled
window), `launches` (the port's kernel launches in that window), `window`
(epochs or calls, seconds, sizes, the networks' operations per unit) and
`agent` (the port's learner)."""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    path = os.path.join(HERE, name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read(names: Sequence[str], ctx) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds a value."""
    from ..spec import metric_units

    units = metric_units()
    out = {}
    for name in names:
        value = reader(name)(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out
