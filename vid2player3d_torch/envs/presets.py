"""(env config, learner config) pairs of the named run configurations.

A view over ``cli/configs.py``, the port's one table of named configs:
`PRESETS[name]` is the imitation or tennis config `name`'s (env config,
learner config), and `preset(name, **env_overrides)` returns them with env
config fields replaced (e.g. `num_envs`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..cli.configs import CONFIGS, get_config


def _pair(cfg):
    if cfg.kind == "im":
        return cfg.env_im, cfg.ppo
    return cfg.env_tennis, cfg.v2p


PRESETS: Dict[str, Tuple[object, object]] = {
    name: _pair(cfg) for name, cfg in CONFIGS.items() if cfg.kind in ("im", "tennis")}

# the corrupted-context transform of amass_im_corrupt
AMASS_IM_CORRUPT_SPECS = get_config("amass_im_corrupt").env_im.transform_specs


def preset(name: str, **env_overrides):
    """(env config, learner config) of a named configuration; keyword
    arguments replace env config fields (e.g. `num_envs`)."""
    env_cfg, learner_cfg = PRESETS[name]
    return dataclasses.replace(env_cfg, **env_overrides), learner_cfg
