"""Operations and bytes of the networks and kernels, computed from shapes.

A linear layer of `i` inputs and `o` outputs over `r` rows takes 2·r·i·o
operations forward; its backward takes as many again for the weight's
gradient and, except for a trunk's first layer (whose input, the observation,
needs no gradient), as many for the input's. Physics, rewards and the rest of
the env step are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence


def mlp_layers(in_dim: int, units: Sequence[int]):
    dims = [in_dim] + list(units)
    return list(zip(dims[:-1], dims[1:]))


def actor_critic_forward(obs_dim: int, num_actions: int, actor_units, critic_units,
                         rows: int) -> Dict[str, float]:
    """One forward of both trunks (bf16) and both heads (f32) over `rows`."""
    trunk = sum(2.0 * rows * i * o for units in (actor_units, critic_units)
                for i, o in mlp_layers(obs_dim, units))
    heads = 2.0 * rows * (actor_units[-1] * num_actions + critic_units[-1])
    return {"bf16": trunk, "f32": heads}


def actor_critic_train_step(obs_dim: int, num_actions: int, actor_units, critic_units,
                            rows: int) -> Dict[str, float]:
    """Forward and backward of one optimizer step over `rows` samples."""
    out = {"bf16": 0.0, "f32": 0.0}
    for units, n_out in ((actor_units, num_actions), (critic_units, 1)):
        for j, (i, o) in enumerate(mlp_layers(obs_dim, units)):
            out["bf16"] += 2.0 * rows * i * o * (2 if j == 0 else 3)
        out["f32"] += 2.0 * rows * units[-1] * n_out * 3
    return out


def add(*parts: Dict[str, float], scale: float = 1.0) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v * scale
    return out


def actor_critic_epoch(obs_dim: int, num_actions: int, actor_units, critic_units, envs: int,
                       horizon: int, mini_epochs: int, minibatch: int) -> Dict[str, float]:
    """A PPO epoch: a forward per env step (and one for the last value), then
    mini_epochs · (envs · horizon / minibatch) optimizer steps."""
    fwd = actor_critic_forward(obs_dim, num_actions, actor_units, critic_units, envs)
    steps = mini_epochs * (envs * horizon // minibatch)
    train = actor_critic_train_step(obs_dim, num_actions, actor_units, critic_units, minibatch)
    return add(add(fwd, scale=horizon + 1), add(train, scale=steps))


def moe_linear(batch: int, layers: Sequence[Sequence[int]], experts: int) -> Dict[str, float]:
    """K2, one decode of `layers` (in, out) at `batch` rows: operations
    (the blended products, 2·E·B·in·out per layer) and bytes (x, coeff, W,
    bias read once, the output written once; float32)."""
    ops = sum(2.0 * experts * batch * i * o for i, o in layers)
    nbytes = 4.0 * sum(batch * i + batch * experts + experts * i * o + experts * o + batch * o
                       for i, o in layers)
    return {"ops": ops, "bytes": nbytes}


def fk_chain_bytes(n: int, joints: int) -> float:
    """K3, one FK of `n` envs over `joints` joints: per joint the local
    rotation (9) and offset (3) read once and the position (3) and rotation
    (9) written once, and the root (3) read once; float32."""
    return 4.0 * n * (joints * (9 + 3 + 3 + 9) + 3)
