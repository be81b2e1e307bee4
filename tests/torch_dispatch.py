"""The dispatch check of the staged (graph-captured) bodies, shared by the
tests of the port's CUDA-graph paths: `_refused(fn)` runs `fn` under a
dispatch mode and names the ops it dispatched that a CUDA graph cannot hold.
It imports no JAX.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops a CUDA graph cannot hold: a read of a device value on the host, a
# shape that depends on data, a tensor made from host data ("host data"; a
# 0-d one is a Python scalar, which the card takes as a fill), and the
# solvers that read their convergence info back to the host on the card
# (the CPU runs them without a sync)
_REFUSED = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "repeat_interleave",
            "item", "host data", "boolean index", "scalar index_put",
            "linalg_svd", "_linalg_svd", "linalg_eigh", "_linalg_eigh", "linalg_eig")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        self.names.add(name)
        if name == "lift_fresh" and args[0].dim() > 0:
            self.names.add("host data")
        if name in ("index", "index_put", "index_put_"):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]
                   if i is not None):
                self.names.add("boolean index")
            # a Python scalar assigned through a tensor index is a 0-d tensor
            # on the host, which the card would copy in
            if name != "index" and args[2].dim() == 0:
                self.names.add("scalar index_put")
        return func(*args, **(kwargs or {}))


def _refused(fn):
    with _Ops() as ops:
        fn()
    return sorted(n for n in ops.names if n in _REFUSED)
