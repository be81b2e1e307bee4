"""K2: the blended-expert linear layer of the MVAE decoder.

Port of the Pallas TPU kernel of ``vid2player3d_tpu/ops/moe_linear.py``
(`_moe_linear` / `_moe_kernel`). Per sample,

    out[b] = sum_e coeff[b, e] * (x[b] @ W[e] + bias[e])

x (B, in), coeff (B, E), W (E, in, out), bias (E, out), all float32. The CUDA
kernel is ``csrc/moe_linear.cu``: a register-tiled f32 product over the
(expert, in) reduction with the coefficient folded into the staged x tile,
so one register accumulator holds the blend and the output is written once,
with no (B, E, out) intermediate. It is bound by f32 operations (see the note
there).

`moe_linear` takes its plain version (`moe_linear_ref`, the apply-then-blend
formulation of the JAX package) only for CPU tensors; for a CUDA tensor it
launches the kernel or raises. Either way it runs inside an
`autograd.Function` whose backward is the plain transcription of the JAX
package's `_moe_bwd` (dx, dcoeff, dW, dbias), which only MVAE training needs.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def moe_linear_ref(x, coeff, w, b):
    """Plain version: per-expert products, then the coefficient blend."""
    per_expert = torch.einsum("bi,eio->beo", x, w)
    out = torch.einsum("be,beo->bo", coeff, per_expert)
    return out + coeff @ b


def _moe_bwd(x, coeff, w, b, g):
    """(dx, dcoeff, dw, db) of `moe_linear` for the output cotangent g."""
    g_per = torch.einsum("bo,eio->bei", g, w)
    dx = torch.einsum("be,bei->bi", coeff, g_per)
    dw = torch.einsum("be,bi,bo->eio", coeff, x, g)
    per_expert = torch.einsum("bi,eio->beo", x, w)
    dcoeff = torch.einsum("beo,bo->be", per_expert, g) + g @ b.T
    db = coeff.T @ g
    return dx, dcoeff, dw, db


def _check(x, coeff, w, b):
    for name, t in (("x", x), ("coeff", coeff), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or coeff.dim() != 2 or w.dim() != 3 or b.dim() != 2:
        raise ValueError("moe_linear takes x (B,in), coeff (B,E), w (E,in,out), b (E,out)")
    B, d_in = x.shape
    E, _, d_out = w.shape
    if coeff.shape != (B, E) or w.shape[1] != d_in or b.shape != (E, d_out):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, coeff {tuple(coeff.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from .build import load_library

    fn = load_library("moe_linear").moe_linear_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, coeff, w, b):
    fn = _kernel_fn()
    B, d_in = x.shape
    E, _, d_out = w.shape
    out = torch.empty((B, d_out), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), coeff.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
             B, d_in, d_out, E, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_linear launch failed: cudaError {err}")
    moe_linear.launches += 1
    return out


def _forward(x, coeff, w, b):
    if x.device.type == "cpu":
        return moe_linear_ref(x, coeff, w, b)
    if x.device.type == "cuda":
        return _launch(x, coeff, w, b)
    raise ValueError(f"moe_linear takes CPU or CUDA tensors, not {x.device}")


class _MoELinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff, w, b):
        ctx.save_for_backward(x, coeff, w, b)
        return _forward(x, coeff, w, b)

    @staticmethod
    def backward(ctx, g):
        x, coeff, w, b = ctx.saved_tensors
        return _moe_bwd(x, coeff, w, b, g.contiguous())


def moe_linear(x, coeff, w, b):
    """sum_e coeff[:, e] * (x @ w[e] + b[e]). CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    `moe_linear.launches`); anything else raises."""
    _check(x, coeff, w, b)
    return _MoELinear.apply(x, coeff, w, b)


moe_linear.launches = 0
