"""The traced run's instruments: spans the benchmark puts around the calls
into the learner's layers, and the device's timeline from `torch.profiler`.

The spans are the benchmark's own (the port's `record_function` spans do not
run inside a CUDA graph replay): each wraps one call of a learner method on
a host clock synchronized before and after, and is a `record_function`
range, so the profiler's timeline names the host's work by it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

from .device import sync

SPANS = ("epoch", "rollout", "update")


class Spans:
    """Synchronized host-clock spans around methods of an object, by name."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self._wrapped = []

    def wrap(self, obj, method: str, name: str) -> bool:
        """Time every call of `obj.method` as span `name`; False when the
        object has no such method (the metric that reads it then reads
        nothing)."""
        fn = getattr(obj, method, None)
        if fn is None:
            return False
        times = self.times.setdefault(name, [])

        def timed(*a, **kw):
            sync(None)
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
            sync(None)
            times.append(time.perf_counter() - t)
            return out

        setattr(obj, method, timed)
        self._wrapped.append((obj, method))
        return True

    def unwrap(self) -> None:
        for obj, method in self._wrapped:
            delattr(obj, method)
        self._wrapped = []


def launches() -> Dict[str, int]:
    """The port's kernel launch counters by wrapper name (`utils/graphs.py`
    `counters()`: each wrapper's `.launches`, which a replay adds to)."""
    from vid2player3d_torch.utils import graphs

    return {fn.__name__: int(fn.launches) for fn in graphs.counters()}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn: Callable[[], None], top: int = 10) -> dict:
    """Run `fn` (which ends in a synchronize) under the profiler, inside an
    `epoch` span. Returns the window's host seconds (`window_s`), the
    seconds in which some operation ran on the device (`busy_s`, the union
    of the device's intervals), each device operation's summed seconds
    (`by_name`), the `top` longest device operations by name and the `top`
    longest idle gaps named by the innermost benchmark span that the host
    was in when the gap began."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    sync(None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("epoch"):
            fn()
        sync(None)
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, by_name = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name in SPANS:
                continue                    # a span's device-side range, not work
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            by_name[name] = by_name.get(name, 0) + d
        elif name in SPANS:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    outer = [sp for sp in spans if sp[2] == "epoch"]
    lo, hi = (outer[0][0], outer[0][1]) if outer else (busy[0][0] if busy else 0,
                                                       busy[-1][1] if busy else 0)
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)

    def host_in(t):
        inner = [sp for sp in spans if sp[0] <= t < sp[1]]
        return min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "outside"

    return {"window_s": window_s, "busy_s": busy_s,
            "by_name": {k: v * 1e-9 for k, v in by_name.items()},
            "device_ops": [[k[:120], v * 1e-9] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[host_in(t), g * 1e-9] for g, t in gaps[:top]]}
