"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which the wrappers load with ``ctypes``.
`build_kernels()` compiles every stale source in parallel (one ``nvcc`` per
file, all started together) into ``build/kernels/`` beside the package;
`load_library(name)` compiles only `name`'s, at its first use, so a path
that runs one kernel does not wait for the others; `start_build(names)`
compiles on a thread of its own while the caller goes on. A library newer
than its source is reused. One build runs at a time in a process.

Nothing here runs when a module is imported: the CPU tests import every
module of the port on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # every product and sum rounded on its own, as in the plain
              # PyTorch versions the kernels are checked against
              "-fmad=false"]

# flags for one source only: K2 finds libcuda's cuTensorMapEncodeTiled with
# dlopen (older glibc keeps dlopen in libdl)
SOURCE_FLAGS = {"moe_linear": ["-ldl"]}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


# a build started in the background and a `load_library` that needs its
# library wait for each other; the later one finds the library current
_BUILDING = threading.Lock()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_kernels(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the stale kernel sources among `names` (every source if
    None), in parallel; returns {name: ptxas log}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    with _BUILDING:
        return _build(names)


def _build(names: Optional[Sequence[str]]) -> Dict[str, str]:
    sources = sorted(CSRC.glob("*.cu"))
    if names is not None:
        unknown = set(names) - {src.stem for src in sources}
        if unknown:
            raise ValueError(f"no kernel source for {sorted(unknown)}")
        sources = [src for src in sources if src.stem in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        out = library_path(src.stem)
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src), *SOURCE_FLAGS.get(src.stem, [])],
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


def start_build(names: Sequence[str]) -> threading.Thread:
    """Compile the stale sources among `names` on a daemon thread (the
    compilers are processes of their own, so the caller's work goes on);
    `load_library` waits for it. A failure there is not raised: the
    `load_library` that needs the library compiles it again and raises."""
    def build():
        try:
            build_kernels(names)
        except (RuntimeError, OSError):
            pass

    thread = threading.Thread(target=build, name="kernel-build", daemon=True)
    thread.start()
    return thread


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library `name` (its source compiled first if stale),
    loaded once per process."""
    build_kernels([name])
    return ctypes.CDLL(str(library_path(name)))

