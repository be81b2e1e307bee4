"""Read the JAX package's checkpoints and states into the port.

The JAX package saves a pytree to one `.npz` with slash-joined key paths
(``vid2player3d_tpu/utils/checkpoint.py``); an `ImitationPPO` checkpoint holds
`params/params/<layer>/<kernel|bias>`, `opt_state/1/{count,mu/...,nu/...}`,
`obs_norm/{0,1,2}` (n, mean, var), `val_norm/...`, `epoch` and `lr`.

The flax tree maps onto the port's `ActorCritic` state dict:
`actor_mlp/Dense_{0,1,2}` → `actor_mlp.{0,1,2}`, `mu`, `critic_mlp/...`,
`value`; a Dense kernel (in, out) is a Linear weight (out, in). A
context-IK learner nests its trees as `ac/params/...` and `ctx/params/...`;
they map onto the port's `ac.` and `ctx.` submodules, `ctx_mlp/Dense_{0,1}`,
`phis` and `leaf6d` onto `ContextHeads`. A `V2PPPO(num_policies=2)` tree
stacks every leaf (and its Adam moments) on a leading policy axis, which the
port's stacked params keep. The MVAE's flax tree, a JAX `TennisState` and a
JAX ball pool map onto the port's `PoseMixtureVAE`, `TennisState` and
`TennisBallGenerator`. Every float leaf goes through `as_f32`. Load only:
the port writes no checkpoints of its own yet.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..envs.humanoid_im import EnvState
from ..learn.running_norm import RunningNormState
from ..physics.model import ArticulationState

_LAYER = re.compile(r"(?:(?:^|/)(ac|ctx)/params/)?(?:(actor_mlp|critic_mlp|ctx_mlp)/Dense_(\d+)"
                    r"|(mu|value|phis|leaf6d))/(kernel|bias)$")


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def as_f32(arr) -> np.ndarray:
    """A float leaf as a C-ordered float32 array. Checkpoints written before
    the JAX package saved bf16 leaves as f32 hold them as raw 2-byte void
    arrays; their bytes are reinterpreted as bfloat16 and widened exactly."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return raw.view(torch.bfloat16).float().numpy()
    return np.array(arr, dtype=np.float32, order="C")


def _port_name(key: str):
    """Flax key path (any prefix) → (state-dict name, is_kernel), or None."""
    m = _LAYER.search(key)
    if m is None:
        return None
    sub, mlp, layer, head, kind = m.groups()
    name = f"{mlp}.{layer}" if mlp else head
    if sub:
        name = f"{sub}.{name}"
    return f"{name}.{'weight' if kind == 'kernel' else 'bias'}", kind == "kernel"


def _tree_to_state_dict(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        named = _port_name(key)
        if named is None:
            continue
        name, is_kernel = named
        # a kernel (..., in, out) becomes a weight (..., out, in); a leading
        # axis is the policy axis of stacked dual-rally params
        arr = as_f32(arr)
        out[name] = torch.from_numpy(np.ascontiguousarray(np.swapaxes(arr, -1, -2))
                                     if is_kernel else arr)
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


def learner_state_from_jax(flat: Dict[str, np.ndarray], names, device, moment_dtype):
    """What a JAX learner checkpoint holds beside its params: (AdamState with
    the moments in `names` order as `moment_dtype`, obs_norm, val_norm,
    epoch, lr)."""
    from ..learn.optim import AdamState

    mu, nu, count = adam_state_from_jax(flat)
    opt = AdamState(count=torch.as_tensor(count, dtype=torch.int32, device=device),
                    mu=[mu[k].to(device, moment_dtype) for k in names],
                    nu=[nu[k].to(device, moment_dtype) for k in names])
    return (opt, running_norm_from_jax(flat, "obs_norm", device),
            running_norm_from_jax(flat, "val_norm", device), int(flat["epoch"]),
            float(as_f32(flat["lr"])))


def running_norm_from_jax(flat: Dict[str, np.ndarray], name: str, device="cpu"
                          ) -> RunningNormState:
    """A RunningNormState saved as `<name>/0..2` (n, mean, var)."""
    def t(i):
        return torch.as_tensor(as_f32(flat[f"{name}/{i}"]), device=device)

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


# -- the tennis slice ----------------------------------------------------------

_MVAE_DENSE = re.compile(r"(encoder|decoder)/(\w+)/(kernel|bias)$")
_MVAE_MOE = re.compile(r"decoder/(moe\d+)/(w|b)$")


def mvae_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's PoseMixtureVAE state dict from flattened flax params
    (`[params/]encoder/fc1/kernel`, `decoder/moe0/w`, ...): a Dense kernel
    (in, out) becomes a Linear weight (out, in); a MoE layer's `w` (E, in,
    out) and `b` (E, out) are taken as they are."""
    out = {}
    for key, arr in flat.items():
        m = _MVAE_MOE.search(key)
        if m:
            out[f"decoder.{m.group(1)}.{m.group(2)}"] = torch.from_numpy(as_f32(arr))
            continue
        m = _MVAE_DENSE.search(key)
        if m:
            is_kernel = m.group(3) == "kernel"
            arr = as_f32(arr)
            out[f"{m.group(1)}.{m.group(2)}.{'weight' if is_kernel else 'bias'}"] = \
                torch.from_numpy(np.ascontiguousarray(arr.T) if is_kernel else arr)
    return out


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(as_f32(a), device=device)


def tennis_state_from_jax(arrays: Dict[str, np.ndarray], device="cpu"):
    """TennisState from the JAX `TennisState` fields as numpy arrays, keyed
    like the checkpoints: `mvae/<field>` (MVAEPlayerState), `sim/<field>`
    (ArticulationState) and `<field>`; the JAX state's `key` is not part of
    the port's state and is ignored."""
    from ..envs.tennis import TennisState
    from ..tennis.player import MVAEPlayerState

    def build(cls, prefix):
        return cls(**{f.name: _tensor(arrays[prefix + f.name], device)
                      for f in dataclasses.fields(cls)})

    top = {f.name: _tensor(arrays[f.name], device) for f in dataclasses.fields(TennisState)
           if f.name not in ("mvae", "sim")}
    return TennisState(mvae=build(MVAEPlayerState, "mvae/"),
                       sim=build(ArticulationState, "sim/"), **top)


def ball_pool_from_jax(gen, device="cpu"):
    """The port's TennisBallGenerator over the same pool as a JAX-package
    generator (any object with `traj_pool`, `launch_pos`, `launch_vel` and
    `launch_vspin` arrays)."""
    from ..tennis.ball import TennisBallGenerator

    return TennisBallGenerator.from_arrays(
        np.asarray(gen.traj_pool), np.asarray(gen.launch_pos), np.asarray(gen.launch_vel),
        np.asarray(gen.launch_vspin), device=device)
