"""The share of the profiled training epoch in which no operation ran on the
device (1 - busy / window, torch.profiler). An upper bound: the profiler
slows the host more than the device."""


def read(ctx):
    p = ctx.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
