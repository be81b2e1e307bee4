"""K2: the blended-expert linear layer of the MVAE decoder.

Port of the Pallas TPU kernel of ``vid2player3d_tpu/ops/moe_linear.py``
(`_moe_linear` / `_moe_kernel`). Per sample,

    out[b] = sum_e coeff[b, e] * (x[b] @ W[e] + bias[e])

x (B, in), coeff (B, E), W (E, in, out), bias (E, out), all float32. The CUDA
kernels are ``csrc/moe_linear.cu``: one GEMM over the (expert, in) reduction
with the coefficient folded into the A operand and the bias blend as one
more K tile, on the TF32 tensor cores (`wgmma`) with the 3xTF32 split that
keeps f32-grade results, fed by TMA; a prep kernel (`split_weights`) writes
the split, transposed weights W_hi^T and W_lo^T (and bias^T) that the GEMM
reads; each launch is counted (`split_weights.launches`,
`moe_linear.launches`).
The output is written once, with no (B, E, out) intermediate. It is bound by
tensor-core operations (see the note there).

`moe_linear` takes its plain version (`moe_linear_ref`, the apply-then-blend
formulation of the JAX package) only for CPU tensors; for a CUDA tensor it
launches the kernels or raises. Either way it runs inside an
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


def tile_width(d_out: int) -> int:
    """The width BN of the kernel's 192 x BN output tiles: 152 where it needs
    fewer column tiles than 128 (out = 290: two tiles, not three), else 128."""
    return 152 if -(-d_out // 152) < -(-d_out // 128) else 128


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load_library

    lib = load_library("moe_linear")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_split_w_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.moe_split_w_f32.restype = i32
    lib.moe_linear_f32.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.moe_linear_f32.restype = i32
    lib.moe_linear_tiling.argtypes = [i32, ptr]
    lib.moe_linear_tiling.restype = i32
    return lib


def tiling(d_out: int) -> dict:
    """The kernel's tiling for an output width, as the library reports it
    (needs the card: the resident CTAs per SM come from the occupancy API)."""
    info = (ctypes.c_int * 7)()
    err = _lib().moe_linear_tiling(tile_width(d_out), info)
    if err != 0:
        raise RuntimeError(f"moe_linear_tiling failed: {err}")
    keys = ("tile_rows", "tile_cols", "k_tile", "stages", "threads", "smem_bytes",
            "ctas_per_sm")
    return dict(zip(keys, info))


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as `cvt.rna.tf32.f32` rounds: the 10-bit mantissa to
    nearest, ties away from zero (half of the 13 dropped bits added to the
    magnitude, then cleared)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def padded_in(d_in: int, experts: int) -> int:
    """The row length of the split weights (and of x as the kernel reads
    it): max(in, E) rounded up to 4 floats, since TMA wants row strides of 16
    bytes and the bias slot holds E columns."""
    return -(-max(d_in, experts) // 4) * 4


def _split_plain(w, b, d_in4):
    """Plain version of the prep kernel: (W_hi^T, W_lo^T), each
    (E + 1, out, d_in4); slot E holds bias^T in its first E columns."""
    E, d_in, d_out = w.shape
    wt = torch.zeros((E + 1, d_out, d_in4), dtype=torch.float32, device=w.device)
    wt[:E, :, :d_in] = w.transpose(1, 2)
    wt[E, :, :E] = b.T
    hi = tf32_rna(wt)
    return hi, tf32_rna(wt - hi)


def split_weights(w, b, d_in4=None):
    """The TF32 split of W (E, in, out) and bias (E, out), transposed to the
    K-major layout the tensor cores read: (W_hi^T, W_lo^T), each
    (E + 1, out, d_in4), zero in the padding, slot E holding bias^T. CPU
    tensors take the plain version; CUDA tensors launch the prep kernel
    (counted in `split_weights.launches`)."""
    if w.dim() != 3 or b.shape != (w.shape[0], w.shape[2]):
        raise ValueError(f"split_weights takes w (E, in, out) and b (E, out), got "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("w and b must be float32")
    if b.device != w.device or not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("w and b must be contiguous, on one device")
    E, d_in, d_out = w.shape
    d_in4 = padded_in(d_in, E) if d_in4 is None else d_in4
    if d_in4 < padded_in(d_in, E) or d_in4 % 4:
        raise ValueError(f"d_in4 {d_in4} is below {padded_in(d_in, E)} or no multiple of 4")
    if w.device.type == "cpu":
        return _split_plain(w, b, d_in4)
    if w.device.type != "cuda":
        raise ValueError(f"split_weights takes CPU or CUDA tensors, not {w.device}")
    lib = _lib()
    hi = torch.empty((E + 1, d_out, d_in4), dtype=torch.float32, device=w.device)
    lo = torch.empty_like(hi)
    err = lib.moe_split_w_f32(w.data_ptr(), b.data_ptr(), hi.data_ptr(), lo.data_ptr(), d_in,
                              d_in4, d_out, E, torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_split_w launch failed: cudaError {err}")
    split_weights.launches += 1
    return hi, lo


split_weights.launches = 0


def _launch(x, coeff, w, b):
    lib = _lib()
    B, d_in = x.shape
    E, _, d_out = w.shape
    d_in4 = padded_in(d_in, E)
    if d_in4 != d_in or x.data_ptr() % 16:
        # TMA wants 16-byte aligned rows: a zero-padded copy
        xp = torch.zeros((B, d_in4), dtype=torch.float32, device=x.device)
        xp[:, :d_in] = x
        x = xp
    out = torch.empty((B, d_out), dtype=torch.float32, device=x.device)
    if B == 0 or d_out == 0:
        return out
    w_hi, w_lo = split_weights(w, b, d_in4)
    err = lib.moe_linear_f32(x.data_ptr(), coeff.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                             out.data_ptr(), B, d_in4, d_out, E, tile_width(d_out),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_linear launch failed: error {err}")
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
    version; CUDA tensors launch the prep kernel (`split_weights`, counted in
    `split_weights.launches`) and the GEMM kernel (counted in
    `moe_linear.launches`); anything else raises."""
    _check(x, coeff, w, b)
    return _MoELinear.apply(x, coeff, w, b)


moe_linear.launches = 0
