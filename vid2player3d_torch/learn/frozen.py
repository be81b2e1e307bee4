"""Frozen low-level imitation policy for embedding inside the tennis env.

Counterpart of ``vid2player3d_tpu/learn/frozen.py``. The trained imitation
policy is an `ImitatorNet` plus its frozen running obs normalizer; inside the
tennis step it maps the 734-dim imitation obs to its deterministic mu: a
residual around the kinematic target dofs plus the 6-dim residual root
force/torque tail.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils.runtime import resolve_device
from . import running_norm as RN
from .networks import ImitatorNet

IMITATION_OBS_DIM = 734


@dataclasses.dataclass
class FrozenImitator:
    """A trained imitation policy packaged for embedding: the network (its
    parameters frozen) and its obs normalizer."""

    net: ImitatorNet
    obs_norm: RN.RunningNormState
    obs_clip: float = 5.0

    def __post_init__(self):
        self.net.requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, path: str, num_actions: int = 75,
                        obs_dim: int = IMITATION_OBS_DIM, device=None) -> "FrozenImitator":
        """Load a JAX-package `ImitationPPO.save_checkpoint` `.npz` (params +
        running stats). Context-IK checkpoints nest the actor-critic under
        `params/ac`; only that subtree is kept (the context heads are
        train-time machinery)."""
        from ..utils import checkpoint as CK

        dev = resolve_device(device)
        flat = CK.load_npz(path)
        state = CK.params_from_jax({k: v for k, v in flat.items() if k.startswith("params/")})
        if any(k.startswith("ac.") for k in state):
            state = {k[3:]: v for k, v in state.items() if k.startswith("ac.")}
        net = ImitatorNet(num_actions=num_actions, obs_dim=obs_dim)
        net.load_state_dict(state)
        return cls(net=net.to(dev), obs_norm=CK.running_norm_from_jax(flat, "obs_norm", dev))

    @classmethod
    def zeros(cls, num_actions: int = 75, obs_dim: int = IMITATION_OBS_DIM,
              device=None) -> "FrozenImitator":
        """All-zero policy: residual action 0, so the tennis env's physics
        tracks the kinematic targets exactly like the PD-only fallback."""
        dev = resolve_device(device)
        net = ImitatorNet(num_actions=num_actions, obs_dim=obs_dim).to(dev)
        with torch.no_grad():
            for p in net.parameters():
                p.zero_()
        return cls(net=net, obs_norm=RN.RunningNormState.create(obs_dim, dev))

    def __call__(self, obs):
        """Deterministic residual action (N, num_actions) for obs (N, 734)."""
        mu, _ = self.net(RN.normalize(self.obs_norm, obs, self.obs_clip))
        return mu

    def as_pi_low(self) -> Callable:
        """pi_low(obs_734) -> action, for `TennisEnv(pi_low=...)`."""
        return self
