"""Milliseconds per env step of the learner's rollout call inside each epoch
(the benchmark's `rollout` span, synchronized before and after), over the
traced window's epochs."""


def read(ctx):
    times = ctx.spans.get("rollout")
    if not times:
        return None
    return sum(times) / (len(times) * ctx.window["horizon"]) * 1e3
