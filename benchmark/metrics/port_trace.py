"""The port's own tracer (``vid2player3d_torch/utils/trace.py``), read by the
metrics that name it: after the profiled epoch, a fresh train state from the
learner's public `init_state()` trains two epochs with the tracer on (the
first captures the graphs anew, with the device stamps) and the second
epoch's report is kept on `ctx`, so the readers share the two epochs. None
where the port has no tracer, off the card, or when the learner's epochs are
not graphed."""

from __future__ import annotations

import importlib

EPOCHS = 2


def report(ctx):
    """The second traced epoch's report, or None."""
    if hasattr(ctx, "port_trace"):
        return ctx.port_trace
    ctx.port_trace = None
    try:
        trace = importlib.import_module("vid2player3d_torch.utils.trace")
    except ImportError:
        return None
    agent = getattr(ctx, "agent", None)
    if agent is None or not getattr(agent, "graphed", False):
        return None
    ts = agent.init_state()
    was_on = trace.tracer.on
    trace.tracer.enable(True)
    try:
        for _ in range(EPOCHS):
            ts, _ = agent.train_epoch(ts)
    finally:
        trace.tracer.enable(was_on)
    reports = trace.tracer.report()
    if reports and reports[-1]["epoch"] == ts.epoch - 1 and reports[-1]["parts_clock"] == "device":
        ctx.port_trace = reports[-1]
    return ctx.port_trace


def part_ms(ctx, graph: str, *parts: str):
    """The device ms per replay of `graph` that its `parts` take together,
    or None unless every one was read."""
    rep = report(ctx)
    got = (rep or {}).get("graphs", {}).get(graph, {}).get("parts", {})
    if not parts or any(p not in got for p in parts):
        return None
    return sum(got[p]["per_replay_ms"] for p in parts)
