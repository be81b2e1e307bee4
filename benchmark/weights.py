"""Initial weights drawn by the benchmark from the seed, on the device, in one
large call per network: the same tensors go to the port and to the reference."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# a normal clamped at 2 sigma has about this standard deviation of a unit one
_CLAMPED_STD = 0.87962566103423978


def actor_critic_shapes(obs_dim: int, num_actions: int, actor_units: Sequence[int],
                        critic_units: Sequence[int], head_init_scale: float
                        ) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every leaf of an actor-critic with separate MLP
    trunks and linear mu / value heads, in the port's naming; biases have std 0."""
    leaves = []
    for trunk, units, head, n_out in (("actor_mlp", actor_units, "mu", num_actions),
                                      ("critic_mlp", critic_units, "value", 1)):
        dims = [obs_dim] + list(units)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            leaves.append((f"{trunk}.{i}.weight", (b, a), 1.0 / math.sqrt(a) / _CLAMPED_STD))
            leaves.append((f"{trunk}.{i}.bias", (b,), 0.0))
        a = units[-1]
        leaves.append((f"{head}.weight", (n_out, a),
                       head_init_scale / math.sqrt(a) / _CLAMPED_STD))
        leaves.append((f"{head}.bias", (n_out,), 0.0))
    return leaves


def draw(leaves, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One standard normal draw for all weights, clamped at 2 sigma, split
    and scaled per leaf; zero biases. float32 on `device`."""
    sizes = [math.prod(shape) for _, shape, std in leaves if std > 0]
    z = torch.randn(sum(sizes), generator=generator, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, std in leaves:
        if std > 0:
            n = math.prod(shape)
            out[name] = (z[at:at + n] * std).reshape(shape)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def actor_critic(net: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The weights of a configuration's `network` block."""
    return draw(actor_critic_shapes(net["obs_dim"], net["num_actions"], net["actor_units"],
                                    net["critic_units"], net["head_init_scale"]),
                generator, device)
