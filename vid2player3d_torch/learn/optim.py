"""Adam for the PPO update, as lists of leaf tensors updated in place.

Counterpart of the optax chain the JAX learner builds
(`clip_by_global_norm` -> `scale_by_adam` or `scale_by_adam_lowmem` ->
`p += -lr * update`, ``learn/ppo.py`` + ``learn/optim.py``), with the same
order of operations. The moments' dtype selects the variant, as the compute
dtype does in the JAX package:

- float32 moments: optax `scale_by_adam`;
- bfloat16 moments (`scale_by_adam_lowmem`): both moments stored in bf16,
  all arithmetic and bias correction in f32.

The fused single-pass version of the same step is K1, ``ops/fused_adam.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor        # int32 scalar, steps taken
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def init_adam(params: List[torch.Tensor], state_dtype=torch.float32) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=[torch.zeros_like(p, dtype=state_dtype) for p in params],
        nu=[torch.zeros_like(p, dtype=state_dtype) for p in params])


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(t.float() ** 2) for t in tensors]).sum())


@torch.no_grad()
def clip_adam_apply(params, state: AdamState, grads, lr, max_norm: float,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """One optimizer step in place on params and the moments; returns the
    state with the incremented count."""
    g_norm = global_norm(grads)
    keep = g_norm < max_norm
    count = state.count + 1
    c = count.float()
    c1, c2 = 1.0 - b1 ** c, 1.0 - b2 ** c
    for p, m, v, g in zip(params, state.mu, state.nu, grads):
        g = torch.where(keep, g, (g / g_norm) * max_norm)
        if m.dtype == torch.float32:
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g ** 2) + b2 * v)
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
        else:
            m32 = b1 * m.float() + (1.0 - b1) * g
            v32 = b2 * v.float() + (1.0 - b2) * g * g
            step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            m.copy_(m32)
            v.copy_(v32)
        p.add_(-lr * step)
    return AdamState(count=count, mu=state.mu, nu=state.nu)
