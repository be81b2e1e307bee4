"""Device ms per env step of the step graph's `physics` part
(`engine.control_step` inside the env's step: PD control and the
articulation substeps), from the port's tracer: stamps inside each replay,
over the second of two traced epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    return port_trace.part_ms(ctx, "step", "physics")
