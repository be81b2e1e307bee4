"""Device ms per optimizer step of the update graph's `backward` part
(`autograd.grad` of the loss), from the port's tracer: stamps inside each
replay, over the second of two traced epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    return port_trace.part_ms(ctx, "update", "backward")
