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

    def noise_values(self, specs, shape, step=0, generator=None, draws=None, shard=None,
                     device=None):
        """The per-element perturbations of obs or action noise (`specs`:
        `obs_specs` or `act_specs`) at schedule `step`: one tensor of
        `shape` per spec, in spec order, each from its standard draw
        (`draws[i]`, the global one with a `shard`, or from `generator`).
        Drawn before any is applied, they are the draws the spec-by-spec
        loop takes, so a step replayed from a CUDA graph can take them as
        static inputs."""
        return [_value(sp, self._standard(sp, shape, device, generator, draws, i, shard), step)
                for i, sp in enumerate(specs)]

    def step_noise_statics(self, act_shape, obs_shape, device):
        """Static tensors for one step's action and obs noise (one per spec),
        which `draw_step_noise` fills and a CUDA graph's step reads."""
        return ([torch.empty(act_shape, device=device) for _ in self.act_specs],
                [torch.empty(obs_shape, device=device) for _ in self.obs_specs])

    def draw_step_noise(self, act, obs, step, generator, draws_act=None, draws_obs=None):
        """One step's action and obs noise at schedule `step`, drawn (or
        taken from `draws_act`, `draws_obs`, one standard draw per spec) in
        the eager step's order, after its policy noise: each action spec's,
        then each obs spec's; copied into `step_noise_statics`' tensors."""
        for static, specs, draws in ((act, self.act_specs, draws_act),
                                     (obs, self.obs_specs, draws_obs)):
            if static:
                values = self.noise_values(specs, static[0].shape, step, generator, draws,
                                           device=static[0].device)
                for s, v in zip(static, values):
                    s.copy_(v)

    @staticmethod
    def apply_noise(x, specs, values):
        """`x` perturbed by `noise_values`' tensors, spec by spec."""
        for sp, v in zip(specs, values):
            x = _apply(x, v.to(x.dtype), sp.operation)
        return x

    def randomize_obs(self, obs, step=0, generator=None, draws=None, shard=None):
        """Per-element observation noise; `draws[i]` is obs spec i's draw of
        obs's shape (the global one with a `shard`)."""
        return self.apply_noise(obs, self.obs_specs, self.noise_values(
            self.obs_specs, obs.shape, step, generator, draws, shard, obs.device))

    def randomize_actions(self, actions, step=0, generator=None, draws=None, shard=None):
        """Per-element action noise; `draws[i]` is action spec i's draw of
        the actions' shape (the global one with a `shard`)."""
        return self.apply_noise(actions, self.act_specs, self.noise_values(
            self.act_specs, actions.shape, step, generator, draws, shard, actions.device))

    def refresh_env(self, static, env) -> None:
        """Copy `env`'s randomized constants (the model fields and ball
        constants of this randomizer's specs, and the ball's gravity vector
        where the env has one) into `static`'s tensors in place: `static`
        is the one env a CUDA graph steps, `env` an epoch's randomized
        copy, or the base env whose constants are plain floats."""
        for sp in self.model_specs:
            getattr(static.model, sp.field).copy_(getattr(env.model, sp.field))
        for sp in self.ball_specs:
            name = sp.field[len("ball_"):]
            dst, src = getattr(static.ball_params, name), getattr(env.ball_params, name)
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(src)
        if self.ball_specs:
            static._gvec.copy_(env._gvec)

    def static_env(self, env):
        """A copy of `env` whose randomized constants are tensors of its
        own (`refresh_env` writes them): the model fields of the model
        specs cloned, the ball constants of the ball specs as 0-d float32
        tensors on the env's device. `env` itself is not changed."""
        if not (self.model_specs or self.ball_specs):
            return env
        model = dataclasses.replace(env.model, **{sp.field: getattr(env.model, sp.field).clone()
                                                 for sp in self.model_specs})
        if not self.ball_specs:
            return env.with_model(model)
        ball = env.ball_params._replace(**{
            sp.field[len("ball_"):]: torch.tensor(
                getattr(env.ball_params, sp.field[len("ball_"):]), dtype=torch.float32,
                device=env.device) for sp in self.ball_specs})
        return env.with_model(model=model, ball_params=ball)
