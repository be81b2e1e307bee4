"""Native (C++) host-side pieces: the ball-flight simulator behind the
trajectory pool's `backend="native"`, compiled at first use with the local
toolchain and bound with ctypes."""

from .ballsim import build_library, native_available, simulate_flight_native  # noqa: F401
