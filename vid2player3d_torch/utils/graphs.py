"""CUDA graphs: a step over static tensors, captured once and replayed.

JAX runs an epoch as one compiled program (`ImitationPPO._epoch` and
`MVAETrainer._train_fused` under `jax.jit`). The port dispatches every op
from the host, and one env step or optimizer step is thousands of small
kernels, so the card waits for the host. A CUDA graph records a step's
launches once; a replay launches all of them again with one host call.

`StaticGraph(body, device)` holds one such step. `body()` reads and writes
only tensors that outlive it: static inputs refreshed with `copy_` before a
call, static outputs it writes with `copy_`, and tensors updated in place
(params, Adam moments). It draws nothing and never syncs with the host.
`graph(key)`:

- on the CPU runs `body()`;
- on the card, the first call under a key runs `body()` for real on a side
  stream (the warm-up capture asks for: every lazy object, a kernel
  library, K1's scratch, cuBLAS's workspace, exists after it), then captures
  it. A capture records and runs nothing, so the call does one step. Every
  later call under the same key replays the graph; a new key drops it and
  captures anew. The key is the caller's: the shapes, dtypes, static flags
  and the addresses of the tensors read in place (`tensor_key`).

A failure while capturing or replaying raises; nothing is retried eagerly.
A capture refuses the CUDA calls that are unsafe while it records only
from its own thread: other threads (autograd's device threads, which run
the backward, or a communicator's) keep theirs. The garbage collector runs
just before a capture and not during it, so nothing it frees (a learner
and its graphs form a reference cycle) calls the CUDA API mid-capture.

The kernels' launch counters (`leaf_update`, `global_norm_scalars`,
`split_weights`, `moe_linear`, `fk_chain`) count in their Python wrappers,
which a replay does not run. A capture takes back what the wrappers counted
while it recorded and keeps it as `launches`; every replay adds it again.
"""

from __future__ import annotations

import ctypes
import functools
import gc
import importlib
import time
from typing import Callable, Hashable, Sequence, Tuple

import torch


def counters() -> Tuple[Callable, ...]:
    """The wrappers whose `.launches` count the port's kernel launches."""
    ops = __package__.rsplit(".", 1)[0] + ".ops"
    fa = importlib.import_module(ops + ".fused_adam")
    moe = importlib.import_module(ops + ".moe_linear")
    fk = importlib.import_module(ops + ".fk")
    return (fa.leaf_update, fa.global_norm_scalars, moe.split_weights, moe.moe_linear,
            fk.fk_chain)


def tensor_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """(address, shape, dtype) of each tensor: the part of a graph's key that
    changes when a tensor read in place is replaced."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def refresh(static: Sequence[torch.Tensor], values: Sequence[torch.Tensor]) -> None:
    """Copy each value into its static tensor (the addresses stay)."""
    for s, v in zip(static, values):
        s.copy_(v)


@functools.lru_cache(maxsize=None)
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(int(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


class StaticGraph:
    """One step over static tensors: run on the CPU, replayed from a CUDA
    graph on the card. After a capture on the card: `nodes` (the graph's
    node count), `capture_s` and `instantiate_s` (host seconds),
    `pool_bytes` (device memory the graph's private pool holds) and
    `launches` (each counter's launches in one replay). `captures` counts
    the keys taken, on the CPU too (there each new key is what the card
    would capture)."""

    def __init__(self, body: Callable[[], None], device):
        self.body = body
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.key = None
        self.graph = None
        self.stream = None
        self.captures = 0
        self.nodes = 0
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        self.launches: Tuple[int, ...] = ()

    def __call__(self, key: Hashable = ()) -> None:
        if not self.cuda:
            if key != self.key:
                self.key, self.captures = key, self.captures + 1
            self.body()
            return
        if self.graph is not None and key == self.key:
            self.graph.replay()
            for fn, n in zip(counters(), self.launches):
                fn.launches += n
            return
        self._capture(key)

    def _capture(self, key: Hashable) -> None:
        self.graph = self.key = None          # the old graph's pool goes first
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.body()                       # the step itself; its launches are eager ones
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        fns = counters()
        before = [fn.launches for fn in fns]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self.body()                   # recorded, not run
        finally:
            if collecting:
                gc.enable()
            self.launches = tuple(fn.launches - b for fn, b in zip(fns, before))
            for fn, b in zip(fns, before):
                fn.launches = b
        t1 = time.perf_counter()
        graph.instantiate()
        self.instantiate_s, self.capture_s = time.perf_counter() - t1, t1 - t0
        self.nodes = _node_count(graph)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        main.wait_stream(self.stream)
        self.graph, self.key = graph, key
        self.captures += 1
