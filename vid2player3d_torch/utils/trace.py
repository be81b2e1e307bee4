"""The port's tracer: host spans of the graphed epoch's phases, device stamps
at named parts inside the replayed steps, and counters.

Always, nearly free: each graphed training epoch (`ImitationPPO`, `V2PPPO`)
records its phases as host spans, `epoch` > `rollout` (> `reset`: the eager
reset and its draws) > `prepare` (GAE, the running norms, the batch) >
`update` > `finish`. A span holds its name, its parent, the epoch's index
(which all of an epoch's spans share) and its start and end in ns on
`torch.profiler`'s clock: `time.time_ns()` (CLOCK_REALTIME), the clock of
kineto's `start_ns()`. `rollout` and `update` are also `record_function`
ranges, so a profile names the host's work by them. No other name of the
tracer enters the profiler's timeline: kineto puts every range on the
device timeline too, where it would read as device work.

Only when on (`enable()`; off by default):

- `part(name)`, a context manager placed where the work is, inside a
  `StaticGraph`'s body (``utils/graphs.py``) is captured into the graph as
  two stamps, at its start and end: a one-thread kernel
  (``csrc/trace_stamp.cu``) that writes the device's global timer into the
  graph's ring of rows, one row per replay, advanced by the graph itself.
  Parts may nest. On the CPU a part records host ns instead, and the report
  says which clock its parts were read on.
- the phases' edges get the same stamp on the current stream. An anchor
  (synchronize, stamp, synchronize, with the host's time on both sides) at
  the start and the end of each epoch maps the device's clock onto the
  host's.
- the host syncs the epoch makes are counted under
  `torch.cuda.set_sync_debug_mode("warn")`, and each graph's replays and
  captures in the epoch.

The switch is part of every graph's key: turning it on recaptures once, with
the stamps; off, a capture is what an untraced program captures and a part
launches nothing. The stamps are read once, after the epoch's work, so no
stamp makes the host wait inside an epoch. The last `KEEP` epochs stay in
memory; `tracer.report()` gives them.

One tracer per process (`tracer`), as the profiler has one set of ranges:
the parts sit in env code that knows no learner.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import re
import time
import warnings
import weakref
from typing import Dict, List, Optional

import torch

KEEP = 8             # epochs kept in memory
ROWS = 4096          # replays a graph's ring keeps per epoch (amass_im: 3,072 optimizer steps)
WIDTH = 64           # stamps one replay may take
EAGER = 1024         # eager stamps per epoch (phase edges and anchors)
PROFILED = ("rollout", "update")       # phases that are also record_function ranges
CLOCK = "time.time_ns (CLOCK_REALTIME), torch.profiler's event clock"
_SYNC_WARNING = "called a synchronizing CUDA operation"


@functools.lru_cache(maxsize=None)
def _stamp_fn():
    from ..ops.build import load_library

    fn = load_library("trace_stamp").trace_stamp
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stamp(buf: torch.Tensor, row: Optional[torch.Tensor], slot: int, mode: int) -> None:
    """One device stamp on the current stream (``csrc/trace_stamp.cu``)."""
    err = _stamp_fn()(buf.data_ptr(), None if row is None else row.data_ptr(), ROWS, WIDTH, slot,
                      mode, torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace_stamp launch failed: cudaError {err}")


class _Span:
    """A phase span (see the module's docstring)."""

    __slots__ = ("tracer", "name", "rf", "rec")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.rf = torch.profiler.record_function(name) if name in PROFILED else None

    def __enter__(self):
        t = self.tracer
        if self.rf is not None:
            self.rf.__enter__()
        start = time.time_ns()
        stack = t._stack
        self.rec = rec = {"name": self.name, "parent": stack[-1]["name"] if stack else None,
                          "epoch": None if t._open is None else t._open["epoch"],
                          "start_ns": start}
        if t._eager is not None:
            rec["d0"] = t._eager_stamp()
        stack.append(rec)
        return self

    def __exit__(self, exc_type, exc, tb):
        t, rec = self.tracer, self.rec
        if t._eager is not None and exc_type is None:
            rec["d1"] = t._eager_stamp()
        rec["end_ns"] = time.time_ns()
        t._stack.pop()
        if t._open is not None:
            t._open["spans"].append(rec)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


class part:
    """A named part of a graph's step: stamped at its start and end inside
    the graph when the tracer is on; nothing otherwise, or outside a
    `StaticGraph`'s body."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if tracer._body is not None:
            tracer._edge(self.name, True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if tracer._body is not None and exc_type is None:
            tracer._edge(self.name, False)
        return False


class _SyncCount:
    """Host syncs while open, counted from the warnings of
    `torch.cuda.set_sync_debug_mode("warn")` (an "error" mode already set
    stays); every other warning is shown again when it closes."""

    def __init__(self):
        self.prev = torch.cuda.get_sync_debug_mode()
        self.cm = warnings.catch_warnings(record=True)
        self.caught = self.cm.__enter__()
        warnings.simplefilter("always")
        if self.prev < 1:
            torch.cuda.set_sync_debug_mode("warn")
        self.count = 0

    def close(self) -> int:
        torch.cuda.set_sync_debug_mode(self.prev)
        self.cm.__exit__(None, None, None)
        for w in self.caught:
            text = str(w.message)
            if _SYNC_WARNING in text:
                self.count += 1
            elif "sync_debug_mode" not in text and "prototype" not in text:
                warnings.showwarning(w.message, w.category, w.filename, w.lineno)
        return self.count


def _intervals(events):
    """[(name, start, end, ns its nested parts cover)] of one replay's
    (name, begin?, ns) events, paired innermost first."""
    out, open_ = [], []
    for name, begin, ns in events:
        if begin:
            open_.append([ns, 0])
            continue
        start, inner = open_.pop()
        out.append((name, start, ns, inner))
        if open_:
            open_[-1][1] += ns - start
    return out


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Tracer:
    """See the module's docstring. `on` is the switch."""

    def __init__(self):
        self.on = False
        self.epochs = collections.deque(maxlen=KEEP)
        self._graphs = weakref.WeakSet()
        self._body = None          # the StaticGraph whose traced body runs or is captured
        self._open = None          # the open epoch's record
        self._stack: List[dict] = []
        self._eager = None         # the open traced epoch's eager stamps (on the card)
        self._n_eager = 0
        self._eager_bufs: Dict[torch.device, torch.Tensor] = {}

    # -- the switch and the graphs ---------------------------------------------

    def enable(self, on: bool = True) -> None:
        self.on = bool(on)

    def key(self, key):
        """A graph's key with the switch in it (off: the caller's key)."""
        return ("traced", key) if self.on else key

    def register(self, graph) -> None:
        self._graphs.add(graph)

    def prepare(self, graph) -> None:
        """Before a traced capture on the card: the graph's ring and row
        counter (zeroed: rows of an earlier capture are dropped), and the
        stamp kernel loaded by one eager stamp."""
        if not self.on:
            return
        if getattr(graph, "trace_buf", None) is None:
            graph.trace_buf = torch.zeros((ROWS, WIDTH), dtype=torch.int64, device=graph.device)
            graph.trace_row = torch.zeros(1, dtype=torch.int64, device=graph.device)
        _stamp(graph.trace_buf, None, 0, 0)
        graph.trace_row.zero_()
        graph.trace_slots = []

    def running(self, graph):
        """The context of a graph's body: parts stamp into the graph being
        captured (card) or record host ns into a new row (CPU)."""
        return self._running(graph) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _running(self, graph):
        if not graph.cuda:
            graph.trace_host = getattr(graph, "trace_host", [])
            graph.trace_host.append([])
        prev, self._body = self._body, graph
        try:
            yield
        finally:
            self._body = prev

    def _edge(self, name: str, begin: bool) -> None:
        g = self._body
        if g.cuda:
            slot = len(g.trace_slots)
            if slot >= WIDTH:
                raise RuntimeError(f"more than {WIDTH} stamps in one step of graph {g.name!r}")
            g.trace_slots.append((name, begin))
            _stamp(g.trace_buf, g.trace_row, slot, 1 if slot == 0 else 2)
        else:
            g.trace_host[-1].append((name, begin, time.time_ns()))

    # -- the epoch and its spans -------------------------------------------------

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def _eager_stamp(self) -> int:
        slot = self._n_eager
        if slot >= EAGER:
            raise RuntimeError(f"more than {EAGER} eager stamps in one epoch")
        self._n_eager += 1
        _stamp(self._eager, None, slot, 0)
        return slot

    def _anchor(self, device) -> tuple:
        """(eager slot, host ns before, host ns after) of the narrowest of
        three synchronized stamps."""
        best = None
        for _ in range(3):
            torch.cuda.synchronize(device)
            h0 = time.time_ns()
            slot = self._eager_stamp()
            torch.cuda.synchronize(device)
            h1 = time.time_ns()
            if best is None or h1 - h0 < best[2] - best[1]:
                best = (slot, h0, h1)
        return best

    @contextlib.contextmanager
    def epoch(self, index: int, device):
        """The context of one epoch's work: its `epoch` span, and when on its
        stamps and counters. An epoch that raises is not kept."""
        device = torch.device(device)
        sync = self._begin(int(index), device)
        ok = False
        try:
            with self.span("epoch"):
                yield
            ok = True
        finally:
            self._end(device, sync, ok)

    def _begin(self, index: int, device: torch.device):
        rec = {"epoch": index, "device": device.type, "traced": self.on, "spans": []}
        self._open, self._stack = rec, []
        if not self.on:
            return None
        rec["before"] = {g: (g.replays, g.captures) for g in list(self._graphs)}
        for g in list(self._graphs):
            if getattr(g, "trace_row", None) is not None:
                g.trace_row.zero_()
            g.trace_host = []
        if device.type != "cuda":
            return None
        if device not in self._eager_bufs:
            self._eager_bufs[device] = torch.zeros(EAGER, dtype=torch.int64, device=device)
        self._eager, self._n_eager = self._eager_bufs[device], 0
        rec["anchors"] = [self._anchor(device)]
        return _SyncCount()

    def _end(self, device: torch.device, sync: Optional[_SyncCount], ok: bool) -> None:
        rec = self._open
        try:
            if sync is not None:
                rec["host_syncs"] = sync.close()
            if not ok:
                return
            if self.on:
                if device.type == "cuda":
                    rec["anchors"].append(self._anchor(device))
                    rec["eager"] = self._eager[:self._n_eager].tolist()
                rec["graphs"] = self._read_graphs(rec.pop("before"))
            self.epochs.append(rec)
        finally:
            self._open, self._stack, self._eager = None, [], None

    def _read_graphs(self, before) -> Dict[str, dict]:
        out = {}
        for g in list(self._graphs):
            r0, c0 = before.get(g, (0, 0))
            replays, captures = g.replays - r0, g.captures - c0
            if not (replays or captures):
                continue
            if g.cuda:
                rows = []
                if getattr(g, "trace_row", None) is not None and g.trace_slots:
                    n = int(g.trace_row.item())
                    keep = min(n, ROWS)
                    order = [(n - keep + i) % ROWS for i in range(keep)]
                    vals = g.trace_buf[:, :len(g.trace_slots)].cpu().numpy()[order]
                    rows = [[(s[0], s[1], int(v)) for s, v in zip(g.trace_slots, row)]
                            for row in vals]
            else:
                rows = list(getattr(g, "trace_host", []))
            out[g.name] = {"replays": replays, "captures": captures, "rows": rows}
        return out

    # -- the report ----------------------------------------------------------------

    def report(self) -> List[dict]:
        """Each kept epoch's report, oldest first (see `epoch_report`)."""
        return [epoch_report(rec) for rec in self.epochs]


def _host_clock(rec: dict):
    """The function that maps a traced epoch's clock of stamps onto the
    host's: the CPU's stamps are host ns already; the card's are mapped by
    the line through the epoch's two anchors."""
    if rec["device"] != "cuda":
        return lambda t: t
    eager = rec["eager"]
    (g0, h0), (g1, h1) = [(eager[s], (a + b) / 2) for s, a, b in rec["anchors"]]
    rate = (h1 - h0) / (g1 - g0)
    return lambda g: h0 + (g - g0) * rate


def _replays(rec: dict, to_host):
    """{graph: [each replay's [(part, start, end, ns its nested parts
    cover)] on the host's clock]}."""
    return {name: [[(p, to_host(s), to_host(e), inner) for p, s, e, inner in _intervals(row)]
                   for row in g["rows"] if row]
            for name, g in rec["graphs"].items()}


def epoch_report(rec: dict) -> dict:
    """One epoch's report. `spans`: name, parent, epoch, `start_ns` and
    `end_ns` on `clock`, and on the card the device's interval mapped onto
    the same clock (`device_start_ns`, `device_end_ns`). When traced:
    `parts_clock` ("device" on the card, "host" on the CPU), and on that
    clock `epoch_ms` (the epoch span's interval); per graph its `replays`
    and `captures` in the epoch, `rows` (the replays read), `replay_ms` (per
    replay, its first stamp to its last) and per part `total_ms`,
    `per_replay_ms`, `self_per_replay_ms` (less its nested parts) and
    `count`; `outside_graphs_ms` (the epoch's interval less the time inside
    graph replays, by the host phase the host was in where each interval
    began, and its `total`) and `outside_graphs_share` of `epoch_ms`;
    `host_syncs` (the card only)."""
    out = {"epoch": rec["epoch"], "clock": CLOCK, "device": rec["device"],
           "parts_clock": None, "spans": []}
    on_card = rec["traced"] and rec["device"] == "cuda"
    to_host = _host_clock(rec) if rec["traced"] else None
    for s in sorted(rec["spans"], key=lambda s: s["start_ns"]):
        span = {k: s[k] for k in ("name", "parent", "epoch", "start_ns", "end_ns")}
        if on_card:
            span["device_start_ns"] = to_host(rec["eager"][s["d0"]])
            span["device_end_ns"] = to_host(rec["eager"][s["d1"]])
        out["spans"].append(span)
    if not rec["traced"]:
        return out
    out["parts_clock"] = "device" if on_card else "host"
    inside, graphs = [], {}
    for name, replays in _replays(rec, to_host).items():
        parts, spans_ms = {}, []
        for row in replays:
            first, last = min(r[1] for r in row), max(r[2] for r in row)
            inside.append((first, last))
            spans_ms.append((last - first) * 1e-6)
            for p, s, e, inner in row:
                acc = parts.setdefault(p, {"total_ms": 0.0, "self_ms": 0.0, "count": 0})
                acc["total_ms"] += (e - s) * 1e-6
                acc["self_ms"] += (e - s - inner) * 1e-6
                acc["count"] += 1
        for acc in parts.values():
            acc["per_replay_ms"] = acc["total_ms"] / len(spans_ms)
            acc["self_per_replay_ms"] = acc.pop("self_ms") / len(spans_ms)
        g = rec["graphs"][name]
        graphs[name] = {"replays": g["replays"], "captures": g["captures"],
                        "rows": len(spans_ms),
                        "replay_ms": sum(spans_ms) / len(spans_ms) if spans_ms else None,
                        "parts": parts}
    out["graphs"] = graphs
    if "host_syncs" in rec:
        out["host_syncs"] = rec["host_syncs"]
    epoch = next(s for s in out["spans"] if s["name"] == "epoch")
    lo, hi = ((epoch["device_start_ns"], epoch["device_end_ns"]) if on_card
              else (epoch["start_ns"], epoch["end_ns"]))
    out["epoch_ms"] = (hi - lo) * 1e-6
    host = [(s["start_ns"], s["end_ns"], s["name"]) for s in out["spans"]]

    def phase_at(t):
        """The innermost phase the host was in at `t` (host clock)."""
        inner = [h for h in host if h[0] <= t < h[1]]
        return min(inner, key=lambda h: h[1] - h[0])[2] if inner else "epoch"

    by_phase, t = {}, lo
    for s, e in _merge([(max(s, lo), min(e, hi)) for s, e in inside if e > lo and s < hi]):
        if s > t:
            by_phase[phase_at(t)] = by_phase.get(phase_at(t), 0.0) + (s - t) * 1e-6
        t = max(t, e)
    if hi > t:
        by_phase[phase_at(t)] = by_phase.get(phase_at(t), 0.0) + (hi - t) * 1e-6
    total = sum(by_phase.values())
    out["outside_graphs_ms"] = {"total": total, **by_phase}
    out["outside_graphs_share"] = total / out["epoch_ms"]
    return out


def flat(report: dict) -> Dict[str, float]:
    """One epoch's report as `trace/` scalars for a metrics line; device
    numbers under `trace/device.`, host-clock numbers under `trace/host.`."""
    out = {}
    for s in report["spans"]:
        out[f"trace/host.{s['name']}_ms"] = (s["end_ns"] - s["start_ns"]) * 1e-6
        if "device_start_ns" in s:
            out[f"trace/device.{s['name']}_ms"] = (s["device_end_ns"] - s["device_start_ns"]) * 1e-6
    clock = report["parts_clock"]
    if clock is None:
        return out
    for name, g in report.get("graphs", {}).items():
        out[f"trace/{name}.replays"] = g["replays"]
        out[f"trace/{name}.captures"] = g["captures"]
        if g["replay_ms"] is not None:
            out[f"trace/{clock}.{name}.replay_ms"] = g["replay_ms"]
        for p, v in g["parts"].items():
            out[f"trace/{clock}.{name}.{p}_ms_per_replay"] = v["per_replay_ms"]
            if v["self_per_replay_ms"] != v["per_replay_ms"]:
                out[f"trace/{clock}.{name}.{p}_self_ms_per_replay"] = v["self_per_replay_ms"]
    for k, v in report.get("outside_graphs_ms", {}).items():
        out[f"trace/{clock}.outside_graphs_ms.{k}"] = v
    if "outside_graphs_share" in report:
        out[f"trace/{clock}.outside_graphs_share"] = report["outside_graphs_share"]
    if report.get("host_syncs") is not None:
        out["trace/host_syncs"] = report["host_syncs"]
    return out


def chrome_events(rec: dict, base_ns: int = 0) -> List[dict]:
    """One kept epoch (an entry of `tracer.epochs`) as chrome-trace events,
    in µs after `base_ns` on the report's clock, as `torch.profiler`'s
    export writes them: the phases on the host and on the device, and each
    replay's parts."""
    pid, ev = "port tracer", []

    def x(name, tid, s, e, **args):
        ev.append({"ph": "X", "name": name, "pid": pid, "tid": tid,
                   "ts": (s - base_ns) / 1e3, "dur": (e - s) / 1e3, "args": args})

    report = epoch_report(rec)
    for s in report["spans"]:
        x(s["name"], "phases (host)", s["start_ns"], s["end_ns"], epoch=s["epoch"],
          parent=s["parent"])
        if "device_start_ns" in s:
            x(s["name"], "phases (device)", s["device_start_ns"], s["device_end_ns"],
              epoch=s["epoch"], parent=s["parent"])
    if rec["traced"]:
        clock = report["parts_clock"]
        for name, replays in _replays(rec, _host_clock(rec)).items():
            for i, row in enumerate(replays):
                for p, s, e, _ in row:
                    x(p, f"{name} parts ({clock})", s, e, epoch=rec["epoch"], replay=i)
    return ev


def append_chrome_events(path: str, records: List[dict]) -> int:
    """Add the kept epochs' events (`chrome_events`) to a trace that
    `torch.profiler` exported to `path`, on its clock (its
    `baseTimeNanoseconds`), so that one timeline holds both; the file is
    rewritten from the end of its `traceEvents` on. Returns the number of
    events added."""
    with open(path, "rb") as f:
        head = f.read(1 << 14)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    base = int(m.group(1)) if m else 0
    events = [e for r in records for e in chrome_events(r, base)]
    if not events:
        return 0
    with open(path, "r+b") as f:
        f.seek(0, 2)
        size = f.tell()
        n = min(size, 1 << 16)
        f.seek(size - n)
        tail = f.read()
        m = re.search(rb'\]\s*,\s*"traceName"', tail)
        end = m.start() if m else tail.rfind(b"]")
        if end < 0:
            raise ValueError(f"{path}: no traceEvents list found")
        before = tail[:end].rstrip()
        sep = b"" if before.endswith(b"[") else b","
        f.seek(size - n + end)
        f.write(sep + b",".join(json.dumps(e).encode() for e in events) + b"\n" + tail[end:])
        f.truncate()
    return len(events)


tracer = Tracer()
span = tracer.span
