"""Actor-critic network (PyTorch counterpart of ``learn/networks.py``).

`ImitatorNet`: separate actor/critic MLPs [1024, 1024, 512] over the 734-dim
imitation obs, a continuous mu head (fixed log-sigma lives in the learner)
and a value head; the residual action (mu += target dof) is applied by the
caller. `V2PNet`, the high-level tennis policy, is the same module with
(1024, 512) trunks over the 257-dim tennis obs. `ContextHeads` is the
context-IK learner's encoder of the (possibly corrupted) motion context.

Parameters are float32. With `dtype=torch.bfloat16` the trunk layers cast
both their input and their weight to bf16 before the product, as a flax
`Dense(dtype=bf16)` does; the heads always compute in float32.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _variance_scaling_(w: torch.Tensor, scale: float, generator: torch.Generator):
    """Truncated-normal fan-in variance scaling (flax `variance_scaling(scale,
    "fan_in", "truncated_normal")`; scale 1 is lecun_normal): a normal cut at
    ±2σ, σ corrected for the cut."""
    fan_in = w.shape[1]
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class ActorCritic(nn.Module):
    """Separate actor/critic MLP trunks + mu/value heads.

    The heads are small-init (σ scaled by `head_init_scale` relative to
    lecun): the action is a RESIDUAL around the reference target, so the
    policy must start at pure-PD behavior — a default-init head emits ~1-rad
    random dof residuals and ~30 N random root forces."""

    def __init__(self, num_actions: int, obs_dim: int = 734,
                 actor_units: Sequence[int] = (1024, 1024, 512),
                 critic_units: Sequence[int] = (1024, 1024, 512),
                 dtype: torch.dtype = torch.float32, head_init_scale: float = 0.01,
                 generator: torch.Generator = None):
        super().__init__()
        self.dtype = dtype

        def mlp(units):
            dims = [obs_dim] + list(units)
            return nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

        self.actor_mlp = mlp(actor_units)
        self.mu = nn.Linear(actor_units[-1], num_actions)
        self.critic_mlp = mlp(critic_units)
        self.value = nn.Linear(critic_units[-1], 1)
        for layer in list(self.actor_mlp) + list(self.critic_mlp):
            _variance_scaling_(layer.weight, 1.0, generator)
        for layer in (self.mu, self.value):
            _variance_scaling_(layer.weight, head_init_scale ** 2, generator)
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                nn.init.zeros_(layer.bias)

    def _trunk(self, layers, x):
        for layer in layers:
            x = F.relu(F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                                layer.bias.to(self.dtype)))
        return x.float()

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.mu(self._trunk(self.actor_mlp, obs))
        value = self.value(self._trunk(self.critic_mlp, obs))
        return mu, value[..., 0]


class ContextHeads(nn.Module):
    """Context encoder of the corrupted-context IK: the root-relative context
    joint positions (72) and their confidence (24) -> MLP (256, 128, ReLU) ->
    twist residuals `phis` (23x2) and leaf-rotation residuals `leaf6d`
    (5 x rot6d) for the analytic IK. The two heads start at zero, so training
    starts from the identity-twist IK. Always float32."""

    def __init__(self, in_dim: int = 24 * 3 + 24, units: Sequence[int] = (256, 128),
                 generator: torch.Generator = None):
        super().__init__()
        dims = [in_dim] + list(units)
        self.ctx_mlp = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.phis = nn.Linear(units[-1], 46)
        self.leaf6d = nn.Linear(units[-1], 30)
        for layer in self.ctx_mlp:
            _variance_scaling_(layer.weight, 1.0, generator)
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                nn.init.zeros_(layer.bias)
        nn.init.zeros_(self.phis.weight)
        nn.init.zeros_(self.leaf6d.weight)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in self.ctx_mlp:
            x = F.relu(layer(x))
        return self.phis(x), self.leaf6d(x)


ImitatorNet = ActorCritic
V2PNet = ActorCritic
