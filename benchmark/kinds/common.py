"""Pieces every kind shares: the configuration file against the port's named
config, and a file's block as a reference dataclass."""

from __future__ import annotations

import dataclasses
import json


def _plain(v):
    """A value as JSON would hold it (tuples as lists)."""
    return json.loads(json.dumps(v))


def check_program_config(cfg: dict, blocks: dict) -> None:
    """Raise unless each key of each block of the configuration file holds
    the value the port's named config has: the cell runs the configuration
    its file states, or not at all."""
    for block, obj in blocks.items():
        have = _plain(dataclasses.asdict(obj))
        for k, v in cfg[block].items():
            if k not in have:
                raise ValueError(f"{cfg['name']}: the port's {block} config has no {k!r}")
            if _plain(v) != have[k]:
                raise ValueError(f"{cfg['name']}: the port's {block}.{k} is {have[k]!r}, "
                                 f"the benchmark's configuration states {v!r}")


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def as_config(cls, block: dict):
    """A frozen dataclass of the reference from a configuration block."""
    return cls(**{k: _tuples(v) for k, v in block.items()})


def clamp_minibatch(ppo: dict, num_envs: int) -> dict:
    """The command line's `_clamp_minibatch`: at fewer envs than the
    config's (the CPU tests), the minibatch never exceeds the batch and
    divides it."""
    nbatch = num_envs * ppo["horizon"]
    mb = min(ppo["minibatch_size"], nbatch)
    while nbatch % mb:
        mb -= 1
    return {**ppo, "minibatch_size": mb}
