"""The share of a traced epoch's device interval that lies outside the graph
replays (each replay from its first stamp to its last): the eager work and
the device's idle time together, measured without the profiler, from the
port's tracer over the second of two traced epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    rep = port_trace.report(ctx)
    return None if rep is None else rep.get("outside_graphs_share")
