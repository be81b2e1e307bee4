"""Read the JAX package's checkpoints and states into the port.

The JAX package saves a pytree to one `.npz` with slash-joined key paths
(``vid2player3d_tpu/utils/checkpoint.py``); an `ImitationPPO` checkpoint holds
`params/params/<layer>/<kernel|bias>`, `opt_state/1/{count,mu/...,nu/...}`,
`obs_norm/{0,1,2}` (n, mean, var), `val_norm/...`, `epoch` and `lr`.

The flax tree maps onto the port's `ActorCritic` state dict:
`actor_mlp/Dense_{0,1,2}` → `actor_mlp.{0,1,2}`, `mu`, `critic_mlp/...`,
`value`; a Dense kernel (in, out) is a Linear weight (out, in). Load only:
the port writes no checkpoints of its own yet.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..envs.humanoid_im import EnvState
from ..learn.running_norm import RunningNormState
from ..physics.model import ArticulationState

_LAYER = re.compile(r"(actor_mlp|critic_mlp)/Dense_(\d+)/(kernel|bias)$|(mu|value)/(kernel|bias)$")


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port_name(key: str):
    """Flax key path (any prefix) → (state-dict name, is_kernel), or None."""
    m = _LAYER.search(key)
    if m is None:
        return None
    if m.group(1):
        return f"{m.group(1)}.{m.group(2)}.{'weight' if m.group(3) == 'kernel' else 'bias'}", \
            m.group(3) == "kernel"
    return f"{m.group(4)}.{'weight' if m.group(5) == 'kernel' else 'bias'}", m.group(5) == "kernel"


def _tree_to_state_dict(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        named = _port_name(key)
        if named is None:
            continue
        name, is_kernel = named
        arr = np.array(arr.T if is_kernel else arr, dtype=np.float32, order="C")
        out[name] = torch.from_numpy(arr)
    return out


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's ActorCritic state dict from flattened flax params: either a
    checkpoint's keys (`params/params/actor_mlp/...`, the optimizer's moments
    skipped) or a flattened params tree (`params/actor_mlp/...`)."""
    return _tree_to_state_dict(
        {k: v for k, v in flat.items() if not k.startswith("opt_state/")}, "")


def adam_state_from_jax(flat: Dict[str, np.ndarray], prefix: str = "opt_state/1/"
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """(mu, nu, count) of a `ScaleByAdamState` (inside the optax chain tuple
    at `opt_state/1`), keyed and shaped like the port's state dict."""
    mu = _tree_to_state_dict(flat, prefix + "mu/")
    nu = _tree_to_state_dict(flat, prefix + "nu/")
    return mu, nu, int(flat[prefix + "count"])


def running_norm_from_jax(flat: Dict[str, np.ndarray], name: str, device="cpu"
                          ) -> RunningNormState:
    """A RunningNormState saved as `<name>/0..2` (n, mean, var)."""
    def t(i):
        return torch.as_tensor(np.asarray(flat[f"{name}/{i}"], np.float32), device=device)

    return RunningNormState(n=t(0), mean=t(1), var=t(2))


def env_state_from_jax(arrays: Dict[str, np.ndarray], device="cpu") -> EnvState:
    """EnvState from the JAX `EnvState`/`ArticulationState` fields as numpy
    arrays: root_pos, root_quat, root_vel, joint_quat, joint_omega,
    progress, reset_buf, terminate_buf, motion_times."""
    def t(k, dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)

    sim = ArticulationState(root_pos=t("root_pos"), root_quat=t("root_quat"),
                            root_vel=t("root_vel"), joint_quat=t("joint_quat"),
                            joint_omega=t("joint_omega"))
    return EnvState(sim=sim, progress=t("progress", torch.int32),
                    reset_buf=t("reset_buf", torch.int32),
                    terminate_buf=t("terminate_buf", torch.int32),
                    motion_times=t("motion_times"))
