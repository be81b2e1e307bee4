"""K1: fused clip+Adam+apply, one in-place pass per parameter leaf.

Port of the Pallas TPU kernel of ``vid2player3d_tpu/ops/fused_adam.py``
(`_leaf_pallas` / `_kernel`, driven by `fused_clip_adam_apply`). The CUDA
kernel is ``csrc/fused_adam.cu``; it is bound by HBM bytes (see the note
there). Per element, in f32 arithmetic:

    g'   = clip_scale * g
    mu'  = b1*mu + (1-b1)*g'          (f32 or bf16 storage)
    nu'  = b2*nu + (1-b2)*g'^2
    p'   = p - lr * (mu'/c1) / (sqrt(nu'/c2) + eps)

The scalars [clip_scale, lr, c1, c2] come from a separate global-norm pass,
which stays plain PyTorch (the JAX package computes it outside Pallas too),
and stay on the device: the kernel reads them through a pointer.

`leaf_update` takes its plain version (`_leaf_plain`, the `_leaf_plain`
semantics of the JAX package) only for CPU tensors; for a CUDA tensor it
launches the kernel or raises. On Hopper the kernel takes every leaf,
including those the TPU path gave to `_leaf_plain` for their size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

_MOMENT_FNS = {torch.float32: "fused_clip_adam_f32", torch.bfloat16: "fused_clip_adam_bf16"}


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


@functools.lru_cache(maxsize=None)
def _kernel_fn(moment_dtype: torch.dtype):
    """The C entry point for one moment type, built and loaded at first use."""
    from .build import load_library

    fn = getattr(load_library("fused_adam"), _MOMENT_FNS[moment_dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_float] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(p, m, v, g, scalars, b1, b2, eps):
    err = _kernel_fn(m.dtype)(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                              scalars.data_ptr(), p.numel(), b1, b2, 1.0 - b1, 1.0 - b2, eps,
                              torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_clip_adam launch failed: cudaError {err}")


def leaf_update(p, m, v, g, scalars, b1=0.9, b2=0.999, eps=1e-8):
    """One leaf's in-place update. CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in `leaf_update.launches`); anything
    else raises."""
    _check(p, m, v, g, scalars)
    if p.device.type == "cpu":
        _leaf_plain(p, m, v, g, scalars, b1, b2, eps)
    elif p.device.type == "cuda":
        _launch(p, m, v, g, scalars, b1, b2, eps)
        leaf_update.launches += 1
    else:
        raise ValueError(f"fused_clip_adam takes CPU or CUDA tensors, not {p.device}")


leaf_update.launches = 0


def adam_scalars(grads: Sequence[torch.Tensor], count, lr, max_norm: float,
                 b1=0.9, b2=0.999):
    """The global-norm pass: ([clip_scale, lr, c1, c2] on the grads' device,
    incremented count). `count` is the int32 step count before this step."""
    gnorm = torch.sqrt(torch.stack([torch.sum(g.float() ** 2) for g in grads]).sum())
    # clip only when above max_norm
    clip_scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    count = count + 1
    c = count.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    scalars = torch.stack([clip_scale, lr, 1.0 - b1 ** c, 1.0 - b2 ** c])
    return scalars, count


@torch.no_grad()
def fused_clip_adam_apply(params, mu, nu, grads, count, lr, max_norm: float,
                          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One fused optimizer step over lists of leaves, in place on params, mu,
    nu; a drop-in for clip_by_global_norm(max_norm) -> Adam -> p -= lr*step.
    Returns the new step count."""
    scalars, count = adam_scalars(grads, count, lr, max_norm, b1, b2)
    for p, m, v, g in zip(params, mu, nu, grads):
        leaf_update(p, m, v, g.contiguous(), scalars, b1, b2, eps)
    return count
