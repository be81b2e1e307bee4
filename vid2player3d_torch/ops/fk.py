"""K3: world forward kinematics over a static joint tree.

Port of the Pallas TPU kernel `_fk_pallas` of ``vid2player3d_tpu/ops/fk.py``
(wrapped there by `fk_chain`, with `_fk_plain` as its oracle). For each env,

    R_0 = rot_0,  p_0 = root;   R_j = R_par @ rot_j,  p_j = p_par + R_par @ off_j

rot (N, J, 3, 3) local rotations (row 0 the root orientation), off (N, J, 3)
parent-relative offsets, root (N, 3); returns (pos (N, J, 3), rotmat
(N, J, 3, 3)). The CUDA kernel is ``csrc/fk_chain.cu``, one env per thread in
the natural layout; it is bound by device-memory bytes.

`fk_chain` takes its plain version only for CPU tensors. A CUDA tensor
launches the kernel at any N (the TPU wrapper sent N < 256 to the plain path
for its tiling; Hopper has no such rule) or raises. The kernel has no
gradient: the tennis step is never differentiated, so an input that requires
grad raises instead of silently dropping it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..physics import soa


def _fk_plain(rot, off, root_pos, parents):
    """Plain version: the parent chain on the SoA core, in the kernel's
    order of products and sums."""
    def mat_of(j):
        return rot[:, j].permute(1, 2, 0)             # (3, 3, N)

    gR = [mat_of(0)]
    gp = [root_pos.T]
    for j in range(1, len(parents)):
        p = parents[j]
        gp.append(gp[p] + soa.m_vec(gR[p], off[:, j].T))
        gR.append(soa.m_mul(gR[p], mat_of(j)))
    body_pos = torch.stack([v.T for v in gp], dim=1)
    body_rm = torch.stack([m.permute(2, 0, 1) for m in gR], dim=1)
    return body_pos, body_rm


def _check(rot, off, root_pos, parents):
    for name, t in (("rot", rot), ("off", off), ("root_pos", root_pos)):
        if t.device != rot.device:
            raise ValueError(f"{name} is on {t.device}, rot on {rot.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.requires_grad:
            raise RuntimeError("fk_chain has no gradient: pass tensors that do not require grad")
    N, J = rot.shape[0], rot.shape[1]
    if rot.shape != (N, J, 3, 3) or off.shape != (N, J, 3) or root_pos.shape != (N, 3):
        raise ValueError(f"shapes do not agree: rot {tuple(rot.shape)}, off {tuple(off.shape)}, "
                         f"root_pos {tuple(root_pos.shape)}")
    if len(parents) != J or any(not 0 <= parents[j] < j for j in range(1, J)):
        raise ValueError("parents must list one parent per joint with parents[j] < j")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from .build import load_library

    fn = load_library("fk_chain").fk_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _launch(rot, off, root_pos, parents):
    fn = _kernel_fn()
    N, J = rot.shape[0], rot.shape[1]
    rot, off, root_pos = rot.contiguous(), off.contiguous(), root_pos.contiguous()
    pos = torch.empty((N, J, 3), dtype=torch.float32, device=rot.device)
    rm = torch.empty((N, J, 3, 3), dtype=torch.float32, device=rot.device)
    par = (ctypes.c_int * J)(*parents)
    err = fn(rot.data_ptr(), off.data_ptr(), root_pos.data_ptr(), pos.data_ptr(), rm.data_ptr(),
             N, J, par, torch.cuda.current_stream(rot.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fk_chain launch failed: cudaError {err}")
    fk_chain.launches += 1
    return pos, rm


def fk_chain(rot, off, root_pos, parents: Sequence[int]):
    """(body_pos (N, J, 3), body_rotmat (N, J, 3, 3)). CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `fk_chain.launches`); anything else raises."""
    parents = tuple(int(p) for p in parents)
    _check(rot, off, root_pos, parents)
    if rot.device.type == "cpu":
        return _fk_plain(rot, off, root_pos, parents)
    if rot.device.type == "cuda":
        return _launch(rot, off, root_pos, parents)
    raise ValueError(f"fk_chain takes CPU or CUDA tensors, not {rot.device}")


fk_chain.launches = 0
