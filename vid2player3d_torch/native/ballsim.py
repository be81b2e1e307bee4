"""ctypes binding of the native ball-flight simulator (``native/ballsim.cpp``).

The same C++/OpenMP source and compiler flags as the JAX package's binding:
the force model of `tennis/ball.py` `simulate_flight` integrated on the host,
one ball per OpenMP iteration. The trajectory pool generator's
`backend="native"` and the `tennis.pool` CLI run it.

The library is compiled with ``g++`` at first use into ``build/native/``
beside the package (a library newer than its source is reused). There is no
fallback: when the compiler or the loader fails, `build_library` and
`simulate_flight_native` raise with the compiler's message, and
`native_available()` answers False.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..tennis import court

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "ballsim.cpp"
LIBRARY = _REPO_ROOT / "build" / "native" / "libballsim.so"
CXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# why the last `native_available()` found no library (None when it did)
build_error: Optional[str] = None


class _CParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in
                ("mass", "radius", "rho", "gravity", "base_cd",
                 "restitution", "friction", "spin_scale", "net_height")]


def build_library(force: bool = False) -> str:
    """Compile ``native/ballsim.cpp`` into ``build/native/libballsim.so``
    unless a library newer than the source is there (`force` rebuilds it
    anyway); returns its path. Raises RuntimeError with the compiler's
    output when g++ fails."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return str(LIBRARY)
    # build beside the target and rename: processes building at once never
    # load a half-written library
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native ballsim: cannot run g++: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"native ballsim: g++ failed:\n{out.stderr}")
    os.replace(tmp, LIBRARY)
    return str(LIBRARY)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_library()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"native ballsim: cannot load {path}: {e}") from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ballsim_simulate.argtypes = [
            f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_CParams), f32p, f32p, f32p, f32p, f32p, f32p,
            f32p, u8p, u8p]
        lib.ballsim_simulate.restype = None
        lib.ballsim_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here. A query, not a switch:
    on False the reason is kept in `build_error`, and `backend="native"`
    still raises."""
    global build_error
    try:
        _load()
    except RuntimeError as e:
        build_error = str(e)
        return False
    build_error = None
    return True


class NativeFlightResult(NamedTuple):
    """`tennis/ball.py` `FlightResult`'s fields (no `bounce_frame`), as host
    numpy arrays."""
    traj: np.ndarray
    bounce_pos: np.ndarray
    bounce_time: np.ndarray
    has_bounce: np.ndarray
    pass_net: np.ndarray
    max_height_after_bounce: np.ndarray
    final_pos: np.ndarray
    final_vel: np.ndarray
    final_vspin: np.ndarray


def simulate_flight_native(pos0, vel0, vspin0, num_frames: int = 100,
                           substeps: int = 4, params=None) -> NativeFlightResult:
    """Batched flight of n balls on the host CPU (OpenMP over balls):
    pos0, vel0 (n, 3), vspin0 (n,) as float32 arrays."""
    lib = _load()
    from ..tennis.ball import DEFAULT_PARAMS

    p = params or DEFAULT_PARAMS
    cp = _CParams(mass=p.mass, radius=p.radius, rho=p.rho, gravity=p.gravity,
                  base_cd=p.base_cd, restitution=p.restitution,
                  friction=p.friction, spin_scale=p.spin_scale,
                  net_height=court.NET_HEIGHT)

    pos0 = np.ascontiguousarray(pos0, np.float32)
    vel0 = np.ascontiguousarray(vel0, np.float32)
    vspin0 = np.ascontiguousarray(vspin0, np.float32)
    n = pos0.shape[0]
    if pos0.shape != (n, 3) or vel0.shape != (n, 3) or vspin0.shape != (n,):
        raise ValueError(f"launch states of shapes {pos0.shape}, {vel0.shape}, {vspin0.shape}; "
                         "expected (n, 3), (n, 3), (n,)")
    if num_frames < 1 or substeps < 1:
        raise ValueError(f"num_frames {num_frames}, substeps {substeps}")
    traj = np.empty((n, num_frames, 3), np.float32)
    bounce_pos = np.empty((n, 3), np.float32)
    bounce_time = np.empty(n, np.float32)
    max_h = np.empty(n, np.float32)
    final_pos = np.empty((n, 3), np.float32)
    final_vel = np.empty((n, 3), np.float32)
    final_vspin = np.empty(n, np.float32)
    has_bounce = np.empty(n, np.uint8)
    pass_net = np.empty(n, np.uint8)

    lib.ballsim_simulate(pos0, vel0, vspin0, n, num_frames, substeps,
                         ctypes.byref(cp), traj, bounce_pos, bounce_time,
                         max_h, final_pos, final_vel, final_vspin,
                         has_bounce, pass_net)
    return NativeFlightResult(
        traj=traj, bounce_pos=bounce_pos, bounce_time=bounce_time,
        has_bounce=has_bounce.astype(bool), pass_net=pass_net.astype(bool),
        max_height_after_bounce=max_h, final_pos=final_pos,
        final_vel=final_vel, final_vspin=final_vspin)
