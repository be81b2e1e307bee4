"""Device ms per optimizer step of the update graph's `optimizer` part (the
clip, the optax-chain Adam or K1, the adaptive lr, the stats row), from the
port's tracer: stamps inside each replay, over the second of two traced
epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    return port_trace.part_ms(ctx, "update", "optimizer")
