"""K3: world forward kinematics over a static joint tree.

Port of the Pallas TPU kernel `_fk_pallas` of ``vid2player3d_tpu/ops/fk.py``
(wrapped there by `fk_chain`, with `_fk_plain` as its oracle). For each env,

    R_0 = rot_0,  p_0 = root;   R_j = R_par @ rot_j,  p_j = p_par + R_par @ off_j

rot (N, J, 3, 3) local rotations (row 0 the root orientation), off (N, J, 3)
parent-relative offsets, root (N, 3); returns (pos (N, J, 3), rotmat
(N, J, 3, 3)). The CUDA kernel is ``csrc/fk_chain.cu``: each CTA streams a
run of consecutive envs through a ring in shared memory (one TMA bulk copy
per env row), three lanes per env walk the chain there, and the rows go
back with bulk stores. It is bound by device-memory bytes. `launch_shape`
sets its grid; `kernel_tree` says which of its two builds a tree takes.

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


H100_SMS = 132
CTAS_PER_SM = 4
THREADS = 96
CHUNK = 8        # envs per ring stage
STAGES = 3
OUT_SLOTS = 2


def padded_row(floats: int) -> int:
    """A shared-memory row of `floats`, padded to a multiple of 4 (16-byte
    copies) that is not one of 8 (so that the envs of a warp spread over the
    banks): 216 -> 220 and 72 -> 76 at J = 24."""
    r = -(-floats // 4) * 4
    return r if r % 8 else r + 4


@functools.lru_cache(maxsize=None)
def launch_shape(n: int, joints: int, sms: int = H100_SMS) -> dict:
    """The kernel's grid for N envs of `joints` joints on a card of `sms`
    SMs: about four CTAs of 96 threads per SM (the kernel's registers allow
    four), each owning a contiguous run of `envs_per_cta` envs (20 at
    N = 10,240, so every SM holds at most 80; one env per CTA at small N),
    walked in chunks of 8 envs through a ring of 3 stages. Its shared memory holds the ring (each stage a chunk's padded
    rot and off rows and its root rows) and two output slabs of a chunk's
    padded rotmat and pos rows. `csrc/fk_chain.cu` lays out and checks the
    same bytes."""
    envs = max(1, -(-n // max(1, min(n, CTAS_PER_SM * sms))))
    rows = padded_row(9 * joints) + padded_row(3 * joints)
    return {"envs_per_cta": envs, "ctas": -(-n // envs), "threads": THREADS,
            "chunks_per_cta": -(-envs // CHUNK),
            "smem_bytes": 4 * (STAGES * CHUNK * (rows + 3) + OUT_SLOTS * CHUNK * rows)}


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from .build import load_library

    fn = load_library("fk_chain").fk_chain_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def kernel_tree(parents) -> int:
    """The build of the kernel that a tree (a tuple of parents) launches: 1,
    straight-line code, for the humanoid's MuJoCo body order (the tennis
    path's); 0, a loop, for any other tree."""
    from .build import load_library

    fn = load_library("fk_chain").fk_chain_tree
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(_parent_array(parents), len(parents))


@functools.lru_cache(maxsize=None)
def _parent_array(parents):
    return (ctypes.c_int * len(parents))(*parents)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(rot, off, root_pos, parents):
    fn = _kernel_fn()
    N, J = rot.shape[0], rot.shape[1]
    dev = rot.device
    shape = launch_shape(N, J, _sm_count(dev.index if dev.index is not None
                                         else torch.cuda.current_device()))
    # a contiguous view at any (4-byte) offset goes in as it is
    rot, off, root_pos = rot.contiguous(), off.contiguous(), root_pos.contiguous()
    pos = torch.empty((N, J, 3), dtype=torch.float32, device=dev)
    rm = torch.empty((N, J, 3, 3), dtype=torch.float32, device=dev)
    err = fn(rot.data_ptr(), off.data_ptr(), root_pos.data_ptr(), pos.data_ptr(), rm.data_ptr(),
             N, J, _parent_array(parents), shape["envs_per_cta"], shape["smem_bytes"],
             torch.cuda.current_stream(dev).cuda_stream)
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
