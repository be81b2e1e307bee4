"""The whole training epoch's share of the chip's peak, in %: the least time
the networks' operations need at their precisions' peaks (``flops.py``,
``peaks.py``: bf16 trunks, f32 heads, MotionVAE decodes in TF32), over the
mean epoch time of the traced window. Physics is not counted."""

from benchmark.peaks import least_seconds


def read(ctx):
    w = ctx.window
    if not w.get("units"):
        return None
    return least_seconds(w["flops"]) / (w["seconds"] / w["units"]) * 100.0
