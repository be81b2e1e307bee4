"""The check that nothing a run loaded is JAX or the JAX package: each
module's top-level name (the part before the first dot), compared whole."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vid2player3d_tpu")


def found(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among `modules` (`sys.modules` unless
    given)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
