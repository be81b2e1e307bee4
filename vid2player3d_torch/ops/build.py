"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which the wrappers load with ``ctypes``.
The sources compile in parallel (one ``nvcc`` per file, all started
together) into ``build/kernels/`` beside the package, at first use; a library
newer than its source is reused.

Nothing here runs when a module is imported: the CPU tests import every
module of the port on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # every product and sum rounded on its own, as in the plain
              # PyTorch versions the kernels are checked against
              "-fmad=false"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every stale kernel source; returns {name: ptxas log}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = library_path(src.stem)
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library `name` (built first if stale), loaded once per
    process."""
    build_kernels()
    return ctypes.CDLL(str(library_path(name)))

