"""Device ms per optimizer step of the update graph's `gather` and `forward`
parts (the minibatch through `idx`; `_loss`, where the trunks' bf16 casts
run), from the port's tracer: stamps inside each replay, over the second of
two traced epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    return port_trace.part_ms(ctx, "update", "gather", "forward")
