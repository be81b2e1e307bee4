"""Checkpoints (`checkpoint`) and device resolution (`runtime`).

`checkpoint` is bound at its first use: it imports the envs and learners,
which import `runtime` from here, so binding it eagerly would make every
first import of the package a cycle.
"""

import importlib

__all__ = ["checkpoint"]


def __getattr__(name):
    if name == "checkpoint":
        return importlib.import_module(".checkpoint", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
