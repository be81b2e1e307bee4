"""Milliseconds per optimizer step of the learner's update call inside each
epoch (the benchmark's `update` span, synchronized before and after), over
the traced window's epochs."""


def read(ctx):
    times = ctx.spans.get("update")
    if not times:
        return None
    return sum(times) / (len(times) * ctx.window["opt_steps"]) * 1e3
