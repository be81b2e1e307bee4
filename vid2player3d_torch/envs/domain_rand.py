"""Domain randomization (PyTorch counterpart of ``envs/domain_rand.py``).

The physics model is a dataclass of per-env tensors, so randomization is a
function `model -> model'` that draws one perturbation per env per field; the
tennis ball's constants take one shared scalar per field; observations and
actions take per-element noise every step. A linear schedule ramps each
perturbation in over policy steps, toward the identity of its operation
(offsets shrink to 0, factors to 1).

Every method takes its standard draws from a `torch.Generator`, or as tensors
handed in (`draws=`, one per spec of that kind, in spec order) so a test can
feed the JAX package's draws. A draw maps to the value as the JAX package
maps its keys' draws:

    uniform      lo + (hi - lo) * u                        u ~ U[0, 1)
    loguniform   exp(log lo + (log hi - log lo) * u)       u ~ U[0, 1)
    gaussian     lo + hi * z                               z ~ N(0, 1)

then `ident + s * (x - ident)` with the schedule scale s.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import draw_rows, global_rows
from ..utils.runtime import as_draw


@dataclasses.dataclass(frozen=True)
class RandSpec:
    """One randomized property."""
    field: str                    # model field, "ball_<name>", "observations" or "actions"
    distribution: str = "uniform"  # uniform | gaussian | loguniform
    rng: Tuple[float, float] = (0.0, 0.0)   # (lo, hi) or (mean, std)
    operation: str = "scaling"    # scaling | additive
    schedule: str = "constant"    # constant | linear
    schedule_steps: int = 1       # policy steps to reach full strength


_MODEL_FIELDS = ("joint_pos", "body_com", "body_mass", "body_inertia",
                 "kp", "kd", "torque_lim", "armature",
                 "contact_offset", "contact_radius")

# the tennis ball's constants (`tennis/ball.py` BallParams); spec field
# "ball_<name>"
_BALL_FIELDS = ("mass", "radius", "base_cd", "restitution", "friction", "spin_scale")


def _sched_scale(spec: RandSpec, step) -> float:
    """The schedule's strength at policy step `step`, as the float32 value
    the JAX package computes (step / steps, clipped to [0, 1])."""
    if spec.schedule == "linear":
        s = np.float32(step) / np.float32(max(spec.schedule_steps, 1))
        return float(np.clip(s, np.float32(0.0), np.float32(1.0)))
    return 1.0


def _f32(x) -> float:
    return float(np.float32(x))


def _value(spec: RandSpec, draw: torch.Tensor, step) -> torch.Tensor:
    """The perturbation factor or offset from a standard draw, schedule
    applied, in float32."""
    lo, hi = spec.rng
    if spec.distribution == "uniform":
        lo32 = _f32(lo)
        x = torch.clamp_min(draw * float(np.float32(hi) - np.float32(lo)) + lo32, lo32)
    elif spec.distribution == "gaussian":
        x = _f32(lo) + _f32(hi) * draw
    else:   # loguniform
        llo, lhi = torch.log(torch.tensor([lo, hi], dtype=torch.float32)).tolist()
        x = torch.exp(torch.clamp_min(draw * float(np.float32(lhi) - np.float32(llo)) + llo,
                                      llo))
    ident = 1.0 if spec.operation == "scaling" else 0.0
    return ident + _sched_scale(spec, step) * (x - ident)


def _apply(value, factor, operation: str):
    return value * factor if operation == "scaling" else value + factor


class DomainRandomizer:
    """Holds the spec list; every method is a function of its inputs."""

    def __init__(self, specs: Sequence[RandSpec]):
        ball = tuple("ball_" + f for f in _BALL_FIELDS)
        for sp in specs:
            if sp.field not in _MODEL_FIELDS + ball + ("observations", "actions"):
                raise ValueError(f"unknown randomization target {sp.field!r}")
            if sp.distribution not in ("uniform", "gaussian", "loguniform"):
                raise ValueError(f"unknown distribution {sp.distribution!r}")
            if sp.operation not in ("scaling", "additive"):
                raise ValueError(f"unknown operation {sp.operation!r}")
        self.specs = tuple(specs)
        self.model_specs = tuple(s for s in specs if s.field in _MODEL_FIELDS)
        self.ball_specs = tuple(s for s in specs if s.field in ball)
        self.obs_specs = tuple(s for s in specs if s.field == "observations")
        self.act_specs = tuple(s for s in specs if s.field == "actions")

    @staticmethod
    def _standard(spec, shape, device, generator, draws, i, shard=None) -> torch.Tensor:
        """Spec i's standard draw: handed in, or from `generator`. With a
        data-parallel `shard` the leading axis is this rank's envs: the draw
        is global (handed in or drawn) and its rows are kept."""
        if draws is not None:
            full = shape if shard is None else (shard.num_envs,) + tuple(shape[1:])
            return global_rows(shard, as_draw(draws[i], torch.float32, device).reshape(full))
        fn = torch.randn if spec.distribution == "gaussian" else torch.rand
        return draw_rows(shard, shape, lambda sh: fn(sh, generator=generator, device=device))

    def model_draws(self, n: int, generator=None, device=None):
        """The standard draws `randomize_model` takes from `generator` for n
        envs, one (n,) tensor per model spec."""
        return [self._standard(sp, (n,), device, generator, None, i)
                for i, sp in enumerate(self.model_specs)]

    def randomize_model(self, model, step=0, generator=None, draws=None, shard=None):
        """Per-env perturbed copy of the articulation model: one draw per env
        per field, broadcast over the field's trailing dims. `draws[i]` holds
        model spec i's N standard draws (global ones with a `shard`)."""
        if not self.model_specs:
            return model
        updates = {}
        for i, sp in enumerate(self.model_specs):
            value = getattr(model, sp.field)
            shape = (value.shape[0],) + (1,) * (value.dim() - 1)
            d = self._standard(sp, shape, value.device, generator, draws, i, shard)
            updates[sp.field] = _apply(value, _value(sp, d, step).to(value.dtype), sp.operation)
        return dataclasses.replace(model, **updates)

    def randomize_ball(self, params, step=0, generator=None, draws=None, device=None):
        """The tennis ball's constants with one shared draw per field; the
        randomized fields become 0-d float32 tensors on `device`. `draws[i]`
        holds ball spec i's standard draw."""
        if not self.ball_specs:
            return params
        updates = {}
        for i, sp in enumerate(self.ball_specs):
            name = sp.field[len("ball_"):]
            d = self._standard(sp, (), device, generator, draws, i)
            updates[name] = _apply(getattr(params, name), _value(sp, d, step), sp.operation)
        return params._replace(**updates)

    def randomize_obs(self, obs, step=0, generator=None, draws=None, shard=None):
        """Per-element observation noise; `draws[i]` is obs spec i's draw of
        obs's shape (the global one with a `shard`)."""
        for i, sp in enumerate(self.obs_specs):
            d = self._standard(sp, obs.shape, obs.device, generator, draws, i, shard)
            obs = _apply(obs, _value(sp, d, step).to(obs.dtype), sp.operation)
        return obs

    def randomize_actions(self, actions, step=0, generator=None, draws=None, shard=None):
        """Per-element action noise; `draws[i]` is action spec i's draw of
        the actions' shape (the global one with a `shard`)."""
        for i, sp in enumerate(self.act_specs):
            d = self._standard(sp, actions.shape, actions.device, generator, draws, i, shard)
            actions = _apply(actions, _value(sp, d, step).to(actions.dtype), sp.operation)
        return actions
