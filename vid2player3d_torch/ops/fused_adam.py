"""K1: the fused clip+Adam+apply step over every parameter leaf.

Port of the Pallas TPU kernel of ``vid2player3d_tpu/ops/fused_adam.py``
(`_leaf_pallas` / `_kernel`, driven by `fused_clip_adam_apply`). The CUDA
kernels are ``csrc/fused_adam.cu``; they are bound by HBM bytes (see the
note there). Per element, in f32 arithmetic:

    g'   = clip_scale * g
    mu'  = b1*mu + (1-b1)*g'          (f32 or bf16 storage)
    nu'  = b2*nu + (1-b2)*g'^2
    p'   = p - lr * (mu'/c1) / (sqrt(nu'/c2) + eps)

On the card one optimizer step is two launches: `global_norm_scalars` (one
multi-tensor reduction over all grads, writing [clip_scale, lr, c1, c2] and
the new step count to the device) and `update_leaves` (one multi-tensor
update over all leaves, reading the scalars through a pointer). On the CPU
the same step is the plain version: `adam_scalars` (the JAX package computes
this pass outside Pallas too) and `_leaf_plain` per leaf.

Each wrapper takes its plain version only for CPU tensors; for a CUDA tensor
it launches its kernel or raises. `leaf_update` is the one-leaf case of
`update_leaves`. Launches are counted in `leaf_update.launches` (the update
kernel) and `global_norm_scalars.launches` (the norm kernel). The norm
kernel's partial sums and counter are one scratch per device, so its calls
on one device are to come from one stream at a time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

_MOMENT_FNS = {torch.float32: "fused_adam_update_f32", torch.bfloat16: "fused_adam_update_bf16"}


def _leaf_plain(p, m, v, g, scalars, b1, b2, eps):
    """Plain PyTorch version: the same arithmetic, in place."""
    clip_scale, lr, c1, c2 = scalars[0], scalars[1], scalars[2], scalars[3]
    g32 = g.float() * clip_scale
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
    step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
    p.sub_(lr * step)
    m.copy_(m32)
    v.copy_(v32)


def _check(p, m, v, g, scalars):
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g), ("scalars", scalars)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p.dtype != torch.float32 or g.dtype != torch.float32 or scalars.dtype != torch.float32:
        raise TypeError("p, g and scalars must be float32")
    if m.dtype != v.dtype or m.dtype not in _MOMENT_FNS:
        raise TypeError(f"moments must both be float32 or bfloat16, got {m.dtype}, {v.dtype}")
    if not (p.numel() == m.numel() == v.numel() == g.numel()):
        raise ValueError("p, m, v, g must have the same number of elements")
    if scalars.numel() != 4:
        raise ValueError("scalars must hold [clip_scale, lr, c1, c2]")


def _check_device(device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_clip_adam takes CPU or CUDA tensors, not {device}")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library, built and loaded at first use, its entry points
    typed."""
    from .build import load_library

    lib = load_library("fused_adam")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in _MOMENT_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, ptr] + [f32] * 5 + [ptr, ptr]
        fn.restype = i32
    lib.fused_adam_norm.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, f32, f32, f32, f32, ptr,
                                    ptr, ptr]
    lib.fused_adam_norm.restype = i32
    for name in ("fused_adam_capacity", "fused_adam_norm_blocks"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.capacity = lib.fused_adam_capacity()          # leaves per launch
    lib.norm_blocks = lib.fused_adam_norm_blocks()    # partial sums per launch
    return lib


class _Leaves:
    """The host table of one list of leaves: int64 rows [p, m, v, g, n], the
    pointers of params and moments filled once, the grads' column filled per
    step. It holds the tensors, so their storage outlives the table. With no
    moments it is a table of grads alone, for the norm kernel."""

    def __init__(self, params, mu=None, nu=None):
        p0 = params[0]
        self.numel = [p.numel() for p in params]
        self.rows = np.zeros((len(params), 5), dtype=np.int64)
        self.rows[:, 4] = self.numel
        self.device, self.moment_dtype = p0.device, torch.float32
        if mu is None:
            self.tensors = ((), (), ())
            return
        self.tensors = (tuple(params), tuple(mu), tuple(nu))
        mdt = mu[0].dtype if mu else torch.float32
        for p, m, v in zip(params, mu, nu):
            if p.device != p0.device or m.device != p0.device or v.device != p0.device:
                raise ValueError("params and moments must share one device")
            if p.dtype != torch.float32:
                raise TypeError("params must be float32")
            if m.dtype != mdt or v.dtype != mdt or mdt not in _MOMENT_FNS:
                raise TypeError(f"moments must all be float32 or all bfloat16, got {m.dtype}, "
                                f"{v.dtype}")
            if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
                raise ValueError("params and moments must be contiguous")
            if not p.numel() == m.numel() == v.numel():
                raise ValueError("p, m, v must have the same number of elements")
        self.moment_dtype = mdt
        self.rows[:, 0] = [p.data_ptr() for p in params]
        self.rows[:, 1] = [m.data_ptr() for m in mu]
        self.rows[:, 2] = [v.data_ptr() for v in nu]

    def matches(self, params, mu, nu) -> bool:
        held = self.tensors
        return (len(params) == len(held[0]) and len(mu) == len(held[1]) == len(nu)
                and all(a is b for a, b in zip(params, held[0]))
                and all(a is b for a, b in zip(mu, held[1]))
                and all(a is b for a, b in zip(nu, held[2])))

    def with_grads(self, grads):
        """The rows with this step's grads (made contiguous where needed)."""
        if len(grads) != len(self.numel):
            raise ValueError(f"{len(grads)} grads for {len(self.numel)} leaves")
        grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
        if any(g.dtype != torch.float32 or g.device != self.device or g.numel() != n
               for g, n in zip(grads, self.numel)):
            raise ValueError("grads must be float32, on the params' device, one per leaf "
                             "with its number of elements")
        self.rows[:, 3] = [g.data_ptr() for g in grads]
        return grads


# The last step's table, reused while its lists hold the same tensors (the
# learner passes the same params and moments every step); like the scratch
# below it is a cache of the process, never read for anything but pointers.
_LAST = [None]


def _leaves(params, mu, nu) -> _Leaves:
    t = _LAST[0]
    if t is None or not t.matches(params, mu, nu):
        t = _LAST[0] = _Leaves(params, mu, nu)
    return t


_SCRATCH = {}   # per device: (f64 partial sums, zeroed counter)


def _scratch(device, chunks):
    need = chunks * _lib().norm_blocks
    s = _SCRATCH.get(device)
    if s is None or s[0].numel() < need:
        s = (torch.empty(need, dtype=torch.float64, device=device),
             torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[device] = s
    return s


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_update(table: _Leaves, scalars, b1, b2, eps, stream):
    n = ctypes.c_int(0)
    err = getattr(_lib(), _MOMENT_FNS[table.moment_dtype])(
        table.rows.ctypes.data, len(table.numel), scalars.data_ptr(), b1, b2, 1.0 - b1, 1.0 - b2,
        eps, stream, ctypes.byref(n))
    leaf_update.launches += n.value
    if err != 0:
        raise RuntimeError(f"fused_adam update launch failed: cudaError {err}")


def _launch_norm(table: _Leaves, count, lr, max_norm, b1, b2, stream):
    """(scalars, new count) from the norm kernel: one buffer of 8 float32,
    the scalars in [0:4], the int32 count in [4]."""
    dev = table.device
    if count.device != dev or count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("count must be one int32 on the grads' device")
    lib = _lib()
    partials, counter = _scratch(dev, max(1, -(-len(table.numel) // lib.capacity)))
    out = torch.empty(8, dtype=torch.float32, device=dev)
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor) and lr.device == dev:
        if lr.numel() != 1:
            raise ValueError("lr must be one value")
        if lr.dtype != torch.float32:
            lr = lr.float()
        lr_ptr = lr.data_ptr()   # read on the device: no host sync
    else:
        lr_value = float(lr)
    n = ctypes.c_int(0)
    base = out.data_ptr()
    err = lib.fused_adam_norm(table.rows.ctypes.data, len(table.numel), partials.data_ptr(),
                              counter.data_ptr(), count.data_ptr(), base + 16, lr_ptr, lr_value,
                              max_norm, b1, b2, base, stream, ctypes.byref(n))
    global_norm_scalars.launches += n.value
    if err != 0:
        raise RuntimeError(f"fused_adam norm launch failed: cudaError {err}")
    new_count = out[4].view(torch.int32)
    return out[:4], new_count.view(count.shape) if count.dim() else new_count


def update_leaves(params, mu, nu, grads, scalars, b1=0.9, b2=0.999, eps=1e-8):
    """The in-place update of every leaf under the given scalars
    [clip_scale, lr, c1, c2]. CPU tensors take the plain version per leaf;
    CUDA tensors launch the multi-tensor kernel (one launch per 64 leaves,
    counted in `leaf_update.launches`); anything else raises."""
    if not params:
        return
    dev = params[0].device
    _check_device(dev)
    if dev.type == "cpu":
        for p, m, v, g in zip(params, mu, nu, grads):
            _check(p, m, v, g, scalars)
            _leaf_plain(p, m, v, g, scalars, b1, b2, eps)
        return
    _lib()
    if scalars.device != dev or scalars.dtype != torch.float32 or scalars.numel() != 4 \
            or not scalars.is_contiguous():
        raise ValueError("scalars must be 4 contiguous float32 on the params' device")
    table = _leaves(params, mu, nu)
    grads = table.with_grads(grads)   # contiguous copies live until the launch is enqueued
    _launch_update(table, scalars, b1, b2, eps, _stream(dev))


def leaf_update(p, m, v, g, scalars, b1=0.9, b2=0.999, eps=1e-8):
    """One leaf's in-place update: the one-leaf case of `update_leaves`."""
    _check(p, m, v, g, scalars)
    _check_device(p.device)
    if p.device.type == "cpu":
        _leaf_plain(p, m, v, g, scalars, b1, b2, eps)
        return
    _lib()
    table = _Leaves([p], [m], [v])
    table.with_grads([g])
    _launch_update(table, scalars, b1, b2, eps, _stream(p.device))


leaf_update.launches = 0


def adam_scalars(grads: Sequence[torch.Tensor], count, lr, max_norm: float,
                 b1=0.9, b2=0.999):
    """The global-norm pass, plain: ([clip_scale, lr, c1, c2] on the grads'
    device, incremented count). `count` is the int32 step count before this
    step."""
    gnorm = torch.sqrt(torch.stack([torch.sum(g.float() ** 2) for g in grads]).sum())
    # clip only when above max_norm
    clip_scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    count = count + 1
    c = count.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    scalars = torch.stack([clip_scale, lr, 1.0 - b1 ** c, 1.0 - b2 ** c])
    return scalars, count


def global_norm_scalars(grads: Sequence[torch.Tensor], count, lr, max_norm: float,
                        b1=0.9, b2=0.999):
    """`adam_scalars` for CPU grads; for CUDA grads one launch of the norm
    kernel per 64 leaves (counted in `global_norm_scalars.launches`)."""
    dev = grads[0].device
    _check_device(dev)
    if dev.type == "cpu":
        return adam_scalars(grads, count, lr, max_norm, b1, b2)
    _lib()
    table = _Leaves(grads)
    grads = table.with_grads(grads)
    return _launch_norm(table, count, lr, max_norm, b1, b2, _stream(dev))


global_norm_scalars.launches = 0


def _check_layout(params, mu, nu, grads, count) -> None:
    """`fused_clip_adam_apply`'s arguments in the port's layout: params, mu,
    nu and grads lists (or tuples) of as many tensors, the count a tensor."""
    n = len(params)
    for name, leaves in (("params", params), ("mu", mu), ("nu", nu), ("grads", grads)):
        if not (isinstance(leaves, (list, tuple)) and len(leaves) == n
                and all(isinstance(x, torch.Tensor) for x in leaves)):
            raise TypeError(f"fused_clip_adam_apply(params, mu, nu, grads, count, lr, max_norm, "
                            f"...): {name} must be a list of {n} tensors, one per leaf, not "
                            f"{type(leaves).__name__}")
    if not isinstance(count, torch.Tensor):
        raise TypeError(f"fused_clip_adam_apply: count must be the step count as a tensor, "
                        f"not {type(count).__name__}")


@torch.no_grad()
def fused_clip_adam_apply(params, mu, nu, grads, count, lr, max_norm: float,
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One fused optimizer step over lists of leaves, in place on params, mu,
    nu; a drop-in for clip_by_global_norm(max_norm) -> Adam -> p -= lr*step.
    On the card: the norm kernel, then the update kernel. Returns the new
    step count.

    The layout departs from the JAX package's `(params, opt_state, grads,
    lr, max_norm, b1, b2, eps, use_pallas, interpret)`: the port has no
    optax state, so the moments and the count come apart and are updated in
    place. A call in the JAX layout raises `TypeError` (`_check_layout`)
    rather than binding the gradients to `nu`."""
    _check_layout(params, mu, nu, grads, count)
    dev = params[0].device
    _check_device(dev)
    if dev.type == "cpu":
        scalars, count = adam_scalars(grads, count, lr, max_norm, b1, b2)
        for p, m, v, g in zip(params, mu, nu, grads):
            g = g.contiguous()
            _check(p, m, v, g, scalars)
            _leaf_plain(p, m, v, g, scalars, b1, b2, eps)
        return count
    _lib()
    table = _leaves(params, mu, nu)
    grads = table.with_grads(grads)   # contiguous copies live until both launches are enqueued
    stream = _stream(dev)
    scalars, count = _launch_norm(table, count, lr, max_norm, b1, b2, stream)
    _launch_update(table, scalars, b1, b2, eps, stream)
    return count
