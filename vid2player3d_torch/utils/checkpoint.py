"""The JAX package's checkpoints and states, read into the port and written
from it.

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
`TennisBallGenerator`. Every float leaf goes through `as_f32`.

The writers are the readers' inverses (`params_to_jax`, `adam_state_to_jax`,
`running_norm_to_jax`, `learner_state_to_jax`, `mvae_params_to_jax`): they
give exactly the keys the JAX package's `_flatten` gives for its learner's
own tree, so its `load_pytree` reads the port's files; bfloat16 leaves are
written as float32, as the JAX writer does. `load_with_surgery` is the JAX
package's `load_pytree_with_surgery` on flat dicts: a leaf lacking one
leading axis is tiled across it, grown dims are padded (0, or the value of
the last `fill_overrides` substring found in the key), a key absent
from the file keeps the template's value, and a shrink raises.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

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


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write flat slash-joined leaves to one `.npz`, as the JAX package's
    `save_pytree` does (its directory made first; numpy adds `.npz` to a
    path without it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def to_numpy(t) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host; bfloat16 widened to
    float32, since `.npz` cannot hold bf16."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


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


def _tree_key(name: str) -> Tuple[str, bool]:
    """The port's state-dict name → (its flax key path inside the learner's
    params tree, is_weight): `actor_mlp.0.weight` → `params/actor_mlp/Dense_0/
    kernel`, `ctx.phis.bias` → `ctx/params/phis/bias`."""
    parts = name.split(".")
    sub = parts.pop(0) if parts[0] in ("ac", "ctx") else None
    kind = parts.pop()
    layer = f"{parts[0]}/Dense_{parts[1]}" if len(parts) == 2 else parts[0]
    key = f"params/{layer}/{'kernel' if kind == 'weight' else 'bias'}"
    return (f"{sub}/{key}" if sub else key), kind == "weight"


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `params_from_jax`: the learner's params (ActorCritic,
    `ac.`/`ctx.` trees, stacked dual leaves) as the flattened flax params
    tree, a weight (..., out, in) written as a kernel (..., in, out)."""
    out = {}
    for name, t in params.items():
        key, is_weight = _tree_key(name)
        arr = to_numpy(t)
        out[key] = np.ascontiguousarray(np.swapaxes(arr, -1, -2)) if is_weight else arr
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


def adam_state_to_jax(opt, names, prefix: str = "opt_state/1/") -> Dict[str, np.ndarray]:
    """Inverse of `adam_state_from_jax`: the optax chain's `ScaleByAdamState`
    (the clip's empty state has no leaves), count as int32, moments as f32."""
    out = {prefix + "count": np.asarray(to_numpy(opt.count), dtype=np.int32)}
    for which, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for k, v in params_to_jax(dict(zip(names, moments))).items():
            out[f"{prefix}{which}/{k}"] = v
    return out


def running_norm_to_jax(state: RunningNormState, name: str) -> Dict[str, np.ndarray]:
    """Inverse of `running_norm_from_jax`: `<name>/0..2` (n, mean, var)."""
    return {f"{name}/{i}": to_numpy(t).astype(np.float32)
            for i, t in enumerate((state.n, state.mean, state.var))}


def learner_state_to_jax(params, opt, obs_norm, val_norm, epoch, lr) -> Dict[str, np.ndarray]:
    """What a JAX learner's `save_checkpoint` writes: params, the optax
    chain's Adam state, both running norms, `epoch` as int32 and `lr` as a
    0-d float32."""
    flat = {"params/" + k: v for k, v in params_to_jax(params).items()}
    flat.update(adam_state_to_jax(opt, list(params)))
    flat.update(running_norm_to_jax(obs_norm, "obs_norm"))
    flat.update(running_norm_to_jax(val_norm, "val_norm"))
    flat["epoch"] = np.asarray(int(epoch), dtype=np.int32)
    flat["lr"] = np.asarray(to_numpy(lr), dtype=np.float32)
    return flat


def _pad_to(src: np.ndarray, shape, fill: float = 0.0) -> np.ndarray:
    if src.ndim != len(shape) or any(s > t for s, t in zip(src.shape, shape)):
        raise ValueError(f"cannot pad {src.shape} -> {tuple(shape)}")
    return np.pad(src, [(0, t - s) for s, t in zip(src.shape, shape)], constant_values=fill)


def load_with_surgery(path: str, like: Dict[str, np.ndarray],
                      fill_overrides: Optional[Dict[str, float]] = None
                      ) -> Dict[str, np.ndarray]:
    """The file's leaves fitted to the template `like` (flat key -> array),
    with the JAX package's `load_pytree_with_surgery` semantics: a leaf with
    one missing leading axis is tiled across it (a single-policy checkpoint
    into stacked dual params); grown dims are padded at the end with 0, or
    with the value of the last `fill_overrides` entry whose key is a
    substring of the leaf's key; a key the file lacks keeps the template's
    value; a leaf that would shrink raises. Each leaf takes the template's
    dtype."""
    data = load_npz(path)
    fill_overrides = fill_overrides or {}
    out = {}
    for key, tgt in like.items():
        tgt = np.asarray(tgt)
        if key not in data:
            out[key] = tgt
            continue
        src = data[key]
        if src.dtype.kind in "fV":      # float leaves, raw bf16 among them
            src = as_f32(src)
        if src.ndim == tgt.ndim - 1 and tgt.ndim >= 1:
            src = np.repeat(src[None], tgt.shape[0], axis=0)
        if src.shape != tgt.shape:
            fill = 0.0
            for sub, v in fill_overrides.items():
                if sub in key:
                    fill = v
            src = _pad_to(src, tgt.shape, fill)
        out[key] = src.astype(tgt.dtype)
    return out


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


def mvae_params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `mvae_params_from_jax`: the keys `_flatten(trainer.params)`
    gives (`encoder/fc1/kernel`, `decoder/moe0/w`, ...)."""
    out = {}
    for name, t in state_dict.items():
        mod, layer, kind = name.split(".")
        arr = to_numpy(t)
        if kind == "weight":
            out[f"{mod}/{layer}/kernel"] = np.ascontiguousarray(arr.T)
        else:
            out[f"{mod}/{layer}/{kind}"] = arr
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
