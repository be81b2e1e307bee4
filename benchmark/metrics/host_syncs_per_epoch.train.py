"""Host syncs the port makes inside one traced epoch, counted by the port's
tracer under `torch.cuda.set_sync_debug_mode("warn")`, over the second of
two traced epochs (``port_trace.py``)."""

from benchmark.metrics import port_trace


def read(ctx):
    rep = port_trace.report(ctx)
    return None if rep is None else rep.get("host_syncs")
