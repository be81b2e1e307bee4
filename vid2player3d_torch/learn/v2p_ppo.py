"""High-level PPO for the hierarchical tennis controller (PyTorch counterpart
of ``vid2player3d_tpu/learn/v2p_ppo.py``).

Differences from `ImitationPPO`, as in the JAX learner:
- the env persists across epochs and done envs reset inside `TennisEnv.step`,
  so the train state carries the env state and its last observation
- no alive-masking: every sample is valid because resets are per step
- aux loss: L2 on the residual-dof slice of mu (`aux_dof_res_coef`)
- rewards sanitized at collection (a non-finite reward becomes 0), and an
  update whose gradient has any non-finite element is skipped (params and
  Adam state unchanged), counted in the `grad_skip` metric
- the optimizer is the optax-chain Adam (``learn/optim.py``), not K1
- domain randomization (the env's `rand_specs`), as in `ImitationPPO`: every
  epoch steps a copy of the env with its model and ball constants perturbed
  from the env's own at schedule step `epoch · horizon`; action noise on
  what the env executes, obs noise on the next obs
- dual rallies (`num_policies=2`): one network per player identity, routed
  by env lane (env i is lane i % num_policies). The params are stacked
  leaves with a leading policy axis, so the optimizer sees one tree and
  clips by one global norm over all policies. Every policy evaluates the
  whole batch and each sample keeps its own lane's output (twice the
  forward, static shapes, and exactly zero gradient into the other
  policy); the lane travels with each sample through GAE, the permutation
  and the loss. The obs normalizer and sigma are shared.

One `train_epoch` = horizon rollout → next-value bootstrap → GAE →
mini_epochs × minibatches. The draws (action noise, minibatch permutations,
the env's per-step draws) come from generators, or from `draws=` so a test
can feed the JAX learner's. On the card, without a mesh (`graphed`:
single-player, two-hand and dual envs, one or two policies, domain
randomization included), each env step and each optimizer step is replayed
from a CUDA graph, as the JAX learner runs its epoch as one jitted program;
the draws stay outside the graphs (`TennisEnv.step_draws`, the
randomization's scheduled noise), and under model or ball randomization the
graphs step one static env whose randomized constants take each epoch's
values in place.

`save_checkpoint` writes, and `load_checkpoint` reads, the JAX package's
`V2PPPO.save_checkpoint` `.npz` (stacked leaves included);
`load_stage_checkpoint` is the curriculum's warm start with the JAX
package's surgery.

Data parallelism (`mesh=`, the env sharded with `env.shard(mesh)`), as the
JAX learner's: the env state and the last obs are this rank's block, the
rest is replicated; the batch is env-major (dp, local_B) with one
permutation per shard; the advantage is normalized by the global unmasked
mean and population std; a minibatch is each shard's `mb_local` rows
(`minibatch_size / D`, or `minibatch_size` with `minibatch_per_chip`). The
gradients and the step's stats are summed over the ranks in one flat bucket
per optimizer step, so the non-finite guard reads the global gradient and
every rank skips together. Each rank's envs per lane must divide, so lane
i % num_policies stays inside the rank. There is no local SGD here, as in
the JAX learner: `dp_sync="per_mini_epoch"` raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..envs.tennis import TennisEnv
from ..envs.tennis_dual import DualTennisEnv
from ..parallel import mesh as PM
from ..utils import graphs
from ..utils import trace
from ..utils.runtime import as_draw, resolve_device
from . import running_norm as RN
from .networks import V2PNet
from .optim import AdamState, clip_adam_apply, init_adam
from .ppo import (PPOConfig, _check_mesh, _minibatches, _replicate_state, _shard_perm,
                  diag_gaussian_neglogp, policy_kl, resolve_compute_dtype)


# the optimizer step's stats (`V2PPPO._loss`), then `grad_skip`
STAT_NAMES = ("a_loss", "c_loss", "b_loss", "kl")


@dataclasses.dataclass(frozen=True)
class V2PConfig(PPOConfig):
    # stage-1 defaults (federer_train_stage_1)
    horizon: int = 64
    mini_epochs: int = 6
    minibatch_size: int = 16384
    learning_rate: float = 1e-4
    sigma_init: float = -0.69
    bounds_loss_coef: float = 10.0
    aux_dof_res_coef: float = 0.0
    actor_units: Tuple[int, ...] = (1024, 512)
    critic_units: Tuple[int, ...] = (1024, 512)
    # dual rallies: one network per player identity, routed by env lane
    num_policies: int = 1


@dataclasses.dataclass
class V2PTrainState:
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    obs_norm: RN.RunningNormState
    val_norm: RN.RunningNormState
    env_state: Any
    last_obs: torch.Tensor
    generator: torch.Generator
    epoch: int
    lr: torch.Tensor


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the non-NaN elements, the mean of the two middle values
    for an even count (NumPy's and JAX's definition; `torch.nanmedian`
    returns the lower one)."""
    return torch.nanquantile(x.reshape(-1), 0.5)


@torch.no_grad()
def _guarded_adam_step(params, opt: AdamState, grads, lr, max_norm: float):
    """Adam step on the gradient with non-finite elements zeroed, kept only
    if every element was finite; otherwise params and Adam state stay as
    they were. Returns (new Adam state, ok as a 0-d bool tensor)."""
    ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    grads = [torch.where(torch.isfinite(g), g, 0.0) for g in grads]
    before = [t.clone() for t in list(params) + opt.mu + opt.nu]
    new = clip_adam_apply(params, opt, grads, lr, max_norm)
    for t, b in zip(list(params) + new.mu + new.nu, before):
        t.copy_(torch.where(ok, t, b))
    count = torch.where(ok, new.count, opt.count)
    return AdamState(count=count, mu=new.mu, nu=new.nu), ok


class V2PPPO:
    """Owns the env and the network; the training state flows through
    `init_state` / `train_epoch`."""

    def __init__(self, env: TennisEnv, cfg: V2PConfig = V2PConfig(), seed: int = 7,
                 mesh=None, device=None):
        if cfg.num_policies < 1:
            raise ValueError(f"num_policies {cfg.num_policies}")
        if cfg.dp_sync != "per_minibatch":
            raise ValueError(f"dp_sync {cfg.dp_sync!r}: V2PPPO syncs every minibatch (the JAX "
                             "learner has no local SGD)")
        self.mesh, self.dp, self.rank = _check_mesh(mesh, env, cfg)
        if env.cfg.num_envs % cfg.num_policies:
            raise ValueError(f"{env.cfg.num_envs} envs per rank do not split into "
                             f"{cfg.num_policies} policy lanes")
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, learner on {self.device}")
        self.env = env
        self.cfg = cfg
        self.seed = seed
        self.num_actions = env.num_actions
        self.obs_dim = env.obs_dim
        self.compute_dtype = resolve_compute_dtype(cfg.compute_dtype, self.device)
        # one network per policy from one seeded generator, in turn; `net`
        # (the first) is the module the stacked params are called through
        gen = torch.Generator().manual_seed(seed)
        self.nets = [V2PNet(num_actions=self.num_actions, obs_dim=self.obs_dim,
                            actor_units=cfg.actor_units, critic_units=cfg.critic_units,
                            dtype=self.compute_dtype, generator=gen).to(self.device)
                     for _ in range(cfg.num_policies)]
        self.net = self.nets[0]
        self.num_policies = cfg.num_policies
        self._lane = torch.arange(env.cfg.num_envs, device=self.device) % self.num_policies
        self.sigma = torch.full((self.num_actions,), float(np.exp(cfg.sigma_init)),
                                device=self.device)
        # the envs of every rank together
        info = getattr(env, "shard_info", None)
        self.num_envs_global = env.cfg.num_envs if info is None else info.num_envs
        self.num_minibatches, self.mb_local = _minibatches(
            self.num_envs_global * cfg.horizon, cfg, self.dp)
        # the env the last epoch stepped (a randomized copy under DR)
        self.last_env = env
        # the graphed epoch's static tensors and graphs (`_statics`)
        self._st = None
        # the graphed evaluation's, one per record set (`eval.py` `_eval_statics`)
        self._eval_st = {}

    def _initial_params(self) -> Dict[str, torch.Tensor]:
        if self.num_policies == 1:
            return dict(self.net.named_parameters())
        named = [dict(n.named_parameters()) for n in self.nets]
        return {k: torch.stack([d[k] for d in named]) for k in named[0]}

    # the fields a warm start may set (the JAX learner's `init_state(warm)`)
    WARM_KEYS = ("params", "opt_state", "obs_norm", "val_norm", "epoch", "lr")

    def init_state(self, warm: Optional[Dict[str, Any]] = None, *,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   reset_draws: Optional[Dict] = None) -> V2PTrainState:
        """A fresh train state: the networks' initial params unless `params`
        is given (with num_policies > 1, leaves stacked on a leading policy
        axis), and a reset of every env (from the env's generator unless
        `reset_draws` is given). `warm` (the JAX learner's argument, from
        `load_stage_checkpoint`'s loader) overrides any of `WARM_KEYS`:
        `params` (as `params=`), `opt_state` (an `AdamState`), `obs_norm`
        and `val_norm` (`RunningNormState`s), `epoch` (an int) and `lr`; each
        is copied onto the learner's device."""
        warm = dict(warm or {})
        unknown = sorted(set(warm) - set(self.WARM_KEYS))
        if unknown:
            raise ValueError(f"warm keys {unknown[:4]} are not among {self.WARM_KEYS} (pass "
                             "the params as params=)")
        if "params" in warm:
            if params is not None:
                raise ValueError("params given twice: as params= and in warm")
            params = warm["params"]
        src = params if params is not None else self._initial_params()
        if self.num_policies > 1:
            bad = [k for k, v in src.items() if v.shape[0] != self.num_policies]
            if bad:
                raise ValueError(f"params {bad} lack the leading axis of {self.num_policies} "
                                 "policies")
        params = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                  for k, v in src.items()}
        env_state, obs = self.env.reset_all(reset_draws)

        def pick(name, default):
            if name not in warm:
                return default
            return PM.tree_map(lambda x: x.detach().to(self.device).clone(), warm[name])

        opt = pick("opt_state", None)
        lr = warm.get("lr", self.cfg.learning_rate)
        return V2PTrainState(
            params=PM.replicate(params, self.mesh),
            opt_state=init_adam(list(params.values()), self.compute_dtype) if opt is None
            else opt,
            obs_norm=pick("obs_norm", RN.RunningNormState.create(self.obs_dim, self.device)),
            val_norm=pick("val_norm", RN.RunningNormState.create(1, self.device)),
            env_state=env_state, last_obs=obs,
            generator=torch.Generator(self.device).manual_seed(self.seed),
            epoch=int(warm.get("epoch", 0)),
            lr=torch.as_tensor(lr, dtype=torch.float32).to(self.device).clone())

    def save_checkpoint(self, path: str, ts: V2PTrainState) -> None:
        """Write params, running stats, Adam state, epoch and lr to one
        `.npz` in the JAX learner's layout; the env state is not saved (a
        resume resets the envs, as in the JAX learner). Under a mesh rank 0
        writes and every rank returns once it is written."""
        from ..utils import checkpoint as CK

        if self.rank == 0:
            CK.save_npz(path, CK.learner_state_to_jax(ts.params, ts.opt_state, ts.obs_norm,
                                                      ts.val_norm, ts.epoch, ts.lr))
        PM.barrier(self.mesh)

    def load_checkpoint(self, path: str, reset_draws: Optional[Dict] = None) -> V2PTrainState:
        """Train state from a JAX-package `V2PPPO.save_checkpoint` `.npz`
        (params, Adam state, running stats, epoch, and lr under the adaptive
        schedule); with num_policies > 1 its leaves carry the policy axis.
        The env state is a fresh reset. Under a mesh rank 0 reads the file and
        every rank takes its values."""
        from ..utils import checkpoint as CK

        if self.rank != 0:
            return _replicate_state(self.init_state(reset_draws=reset_draws), self.mesh)
        return self._state_from_flat(CK.load_npz(path), reset_draws)

    def load_stage_checkpoint(self, path: str, discard_sigma: bool = True,
                              reset_draws: Optional[Dict] = None) -> V2PTrainState:
        """Warm start from an earlier curriculum stage's checkpoint with the
        JAX package's surgery (`utils.checkpoint.load_with_surgery` against
        this learner's fresh state): grown obs/action dims zero-padded in the
        kernels, biases and Adam moments, the `var` override as the JAX
        learner passes it, a single-policy file tiled into num_policies > 1,
        absent keys kept fresh. Epoch, Adam state and running stats carry
        over; lr only under the adaptive schedule. `discard_sigma` is
        accepted and unused, as in the JAX learner: sigma is a config
        constant, not a parameter. Pure: the agent is not changed."""
        from ..utils import checkpoint as CK

        if self.rank != 0:
            return _replicate_state(self.init_state(reset_draws=reset_draws), self.mesh)
        params = self._initial_params()
        like = CK.learner_state_to_jax(
            params, init_adam(list(params.values())),
            RN.RunningNormState.create(self.obs_dim), RN.RunningNormState.create(1),
            0, torch.tensor(self.cfg.learning_rate))
        return self._state_from_flat(CK.load_with_surgery(path, like, {"var": 1.0}),
                                     reset_draws)

    def _state_from_flat(self, flat, reset_draws) -> V2PTrainState:
        """The train state of a checkpoint's flat leaves, through
        `init_state(warm=...)`: params, Adam state, running stats, epoch,
        and lr only under the adaptive schedule."""
        from ..utils import checkpoint as CK

        params = CK.params_from_jax(flat)
        opt, obs_norm, val_norm, epoch, lr = CK.learner_state_from_jax(
            flat, list(params), self.device, self.compute_dtype)
        warm = dict(params=params, opt_state=opt, obs_norm=obs_norm, val_norm=val_norm,
                    epoch=epoch)
        if self.cfg.lr_schedule == "adaptive":
            warm["lr"] = lr
        return _replicate_state(self.init_state(warm, reset_draws=reset_draws), self.mesh)

    # -- forward ----------------------------------------------------------------

    def _apply(self, params, obs_n, lane):
        """(mu, value). With several policies every one evaluates the whole
        batch and each sample keeps its lane's output by a one-hot weighted
        sum over the policies, as the JAX learner's einsum: a non-finite
        output of another policy makes the sample non-finite (0·inf), and the
        update's guard then skips the step."""
        if self.num_policies == 1:
            return functional_call(self.net, params, (obs_n,))
        outs = [functional_call(self.net, {k: v[p] for k, v in params.items()}, (obs_n,))
                for p in range(self.num_policies)]
        # the one-hot rows by a comparison (`one_hot` reads the lanes' range
        # on the host off the card)
        policies = torch.arange(self.num_policies, device=lane.device)
        sel = (policies[:, None] == lane[None]).to(outs[0][0].dtype)
        mu = (torch.stack([o[0] for o in outs]) * sel[..., None]).sum(0)
        value = (torch.stack([o[1] for o in outs]) * sel).sum(0)
        return mu, value

    def _forward(self, params, obs_norm, obs, lane=None):
        obs_n = RN.normalize(obs_norm, obs, self.cfg.obs_clip)
        return self._apply(params, obs_n, self._lane if lane is None else lane)

    def _value(self, ts: V2PTrainState, v_norm):
        if not self.cfg.normalize_value:
            return v_norm
        return RN.unnormalize_value(ts.val_norm, v_norm[:, None])[:, 0]

    # -- rollout ----------------------------------------------------------------

    @property
    def graphed(self) -> bool:
        """Whether `train_epoch` and `rollout` replay their steps from CUDA
        graphs (``utils/graphs.py``), as the JAX learner runs its epoch as one
        jitted program: on the card, without a mesh (every tennis config: the
        stage 1-3 configs, the curriculum aids, the two-hand `djokovic` and
        `nadal`, the dual rallies with their two policies,
        `federer_train_stage_1_dr`). Their steps make no host sync and no
        draw."""
        return self.device.type == "cuda" and self.mesh is None

    @torch.no_grad()
    def rollout(self, ts: V2PTrainState, draws: Optional[Dict] = None,
                env: Optional[TennisEnv] = None):
        """`horizon` steps from the carried env state; returns the (T, N, ...)
        trajectory with the terminate-masked next values, the new env state
        and the last obs. `env` is the env to step (this learner's unless
        given: an epoch's randomized copy)."""
        if self.graphed and (env is None or env is self.env):
            traj, env_state, obs = self._rollout_graphed(ts, draws)
            return (PM.tree_map(torch.clone, traj), PM.tree_map(torch.clone, env_state),
                    obs.clone())
        return self._rollout_eager(ts, draws, env)

    @torch.no_grad()
    def _rollout_eager(self, ts: V2PTrainState, draws: Optional[Dict] = None,
                       env: Optional[TennisEnv] = None):
        """`rollout` op by op from the host: the oracle of the graphed one,
        and every path's rollout off the graphed path."""
        cfg, dev = self.cfg, self.device
        env = self.env if env is None else env
        dr = env.randomizer
        dr_step = ts.epoch * cfg.horizon
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        traj = dict(obs=torch.empty(T, N, self.obs_dim, device=dev),
                    action=torch.empty(T, N, A, device=dev),
                    mu=torch.empty(T, N, A, device=dev))
        for k in ("neglogp", "value", "reward", "done", "terminate"):
            traj[k] = torch.empty(T, N, device=dev)
        subs, extras = [], []
        env_state, obs = ts.env_state, ts.last_obs
        shard = env.shard_info
        for t in range(T):
            mu, v_norm = self._forward(ts.params, ts.obs_norm, obs)
            if draws is None:
                noise = PM.draw_rows(shard, mu.shape, lambda sh: torch.randn(
                    sh, generator=ts.generator, device=dev))
            else:
                noise = PM.global_rows(shard, as_draw(draws["noise"][t], torch.float32, dev))
            action = mu + self.sigma[None] * noise
            # randomization's action noise goes on what the env executes;
            # the stored action stays the policy's
            env_action = action
            if dr is not None and dr.act_specs:
                env_action = dr.randomize_actions(action, dr_step, ts.generator,
                                                  None if draws is None else draws["dr_act"][t],
                                                  shard)
            env_state, out = env.step(env_state, env_action,
                                      None if draws is None else draws["env"][t])
            traj["obs"][t] = obs
            traj["action"][t] = action
            traj["mu"][t] = mu
            traj["neglogp"][t] = diag_gaussian_neglogp(action, mu, self.sigma[None])
            traj["value"][t] = self._value(ts, v_norm)
            # a diverged env's last reward can be non-finite: one NaN would
            # ride through GAE into every advantage
            traj["reward"][t] = torch.where(torch.isfinite(out.reward), out.reward, 0.0)
            traj["done"][t] = out.done.float()
            traj["terminate"][t] = out.terminate.float()
            subs.append(out.sub_rewards)
            extras.append(out.extras)
            obs = out.obs
            if dr is not None and dr.obs_specs:
                obs = dr.randomize_obs(obs, dr_step, ts.generator,
                                       None if draws is None else draws["dr_obs"][t], shard)
        traj["sub_rewards"] = torch.stack(subs)
        traj["extras"] = {k: torch.stack([e[k] for e in extras]) for k in extras[0]}

        # v(obs_{t+1}) is the value computed at step t+1; one extra forward
        # for the final obs closes the horizon
        _, vn_last = self._forward(ts.params, ts.obs_norm, obs)
        v_next = torch.cat([traj["value"][1:], self._value(ts, vn_last)[None]], dim=0)
        traj["next_value"] = v_next * (1.0 - traj["terminate"])
        return traj, env_state, obs

    def _gae(self, traj):
        """delta = r + γ·next_v − v;  A ← delta + γτ(1−done)·A."""
        cfg = self.cfg
        advs = torch.empty_like(traj["reward"])
        lastgaelam = torch.zeros_like(traj["reward"][0])
        for t in range(advs.shape[0] - 1, -1, -1):
            delta = traj["reward"][t] + cfg.gamma * traj["next_value"][t] - traj["value"][t]
            lastgaelam = delta + cfg.gamma * cfg.tau * (1.0 - traj["done"][t]) * lastgaelam
            advs[t] = lastgaelam
        return advs

    # -- update -----------------------------------------------------------------

    def _loss(self, params, mb, obs_norm, count=None):
        """The PPO loss and its stats as means over the minibatch; `count`
        (the global minibatch's size under a mesh) replaces the rows' own
        count, so the ranks' values sum to the global mean."""
        cfg = self.cfg

        def mean(x):
            return x.mean() if count is None else x.sum() / count

        mu, v_norm = self._forward(params, obs_norm, mb["obs"], mb["lane"])
        sigma = self.sigma[None]
        neglogp = diag_gaussian_neglogp(mb["action"], mu, sigma)
        ratio = torch.exp(mb["old_neglogp"] - neglogp)
        surr1 = mb["adv"] * ratio
        surr2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = mean(torch.maximum(-surr1, -surr2))
        c_loss = mean((v_norm - mb["return_norm"]) ** 2)
        b_loss = mean((torch.clamp_min(mu - 1.0, 0.0) ** 2
                       + torch.clamp_max(mu + 1.0, 0.0) ** 2).sum(-1))
        # aux: residual dof close to 0
        nl = self.env.cfg.num_latents
        aux = mean((mu[:, nl:nl + 3] ** 2).sum(-1)) if self.env.cfg.add_residual_dof else 0.0
        loss = (a_loss + cfg.critic_coef * c_loss + cfg.bounds_loss_coef * b_loss
                + cfg.aux_dof_res_coef * aux)
        kl = mean(policy_kl(mu, sigma, mb["old_mu"], sigma))
        return loss, dict(a_loss=a_loss, c_loss=c_loss, b_loss=b_loss, kl=kl)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks (itself without collectives)."""
        return PM.all_reduce_sum(t, self.mesh)

    def _adapt_lr(self, lr, kl):
        cfg = self.cfg
        if cfg.lr_schedule != "adaptive":
            return lr
        return torch.where(kl > 2.0 * cfg.kl_threshold,
                           torch.clamp_min(lr / 1.5, cfg.min_lr),
                           torch.where(kl < 0.5 * cfg.kl_threshold,
                                       torch.clamp_max(lr * 1.5, cfg.max_lr), lr))

    # -- epoch ------------------------------------------------------------------

    def epoch_env(self, ts: V2PTrainState, draws: Optional[Dict] = None) -> TennisEnv:
        """The env an epoch steps: under model or ball randomization a copy
        with the model and ball constants perturbed from this env's own at
        schedule step epoch·horizon (`draws["dr_model"]`: per model spec N
        standard draws; `draws["dr_ball"]`: one per ball spec); otherwise
        this env."""
        env, dr = self.env, self.env.randomizer
        if dr is None or not (dr.model_specs or dr.ball_specs):
            return env
        step = ts.epoch * self.cfg.horizon
        if dr.model_specs:
            env = env.with_randomized_model(dr, step, ts.generator,
                                            None if draws is None else draws["dr_model"])
        if dr.ball_specs:
            env = env.with_model(ball_params=dr.randomize_ball(
                env.ball_params, step, ts.generator, None if draws is None else draws["dr_ball"],
                device=self.device))
        return env

    def train_epoch(self, ts: V2PTrainState, draws: Optional[Dict] = None
                    ) -> Tuple[V2PTrainState, Dict[str, torch.Tensor]]:
        """One epoch. `draws` (optional) holds `noise` (T, N, A), `perms`
        (mini_epochs, T·N) and `env` (T per-step draw dicts of
        `TennisEnv.step`, each holding every draw `TennisEnv.step_draws`
        makes) in place of the generators' draws; under domain randomization
        also `dr_model`, `dr_ball`, `dr_act` (T, per action spec (N, A)) and
        `dr_obs` (T, per obs spec (N, obs_dim)) as standard draws. Params and
        Adam moments are updated in place; returns the new state and the
        metrics as 0-d tensors on the device; the env the epoch stepped is
        kept as `last_env`. On the graphed path (`graphed`) every env step and
        every optimizer step is replayed from a CUDA graph."""
        if self.graphed:
            return self._train_epoch_graphed(ts, draws)
        return self._train_epoch_eager(ts, draws)

    def _train_epoch_eager(self, ts: V2PTrainState, draws: Optional[Dict] = None
                           ) -> Tuple[V2PTrainState, Dict[str, torch.Tensor]]:
        """`train_epoch` op by op from the host."""
        env = self.epoch_env(ts, draws)
        self.last_env = env
        traj, env_state, last_obs = self._rollout_eager(ts, draws, env)
        batch_all, obs_norm_next, val_norm, lr = self._prepare(ts, traj)
        stat_means, lr, opt = self._update_eager(ts, batch_all, lr, draws)
        return self._finish(ts, traj, stat_means, lr, opt, obs_norm_next, val_norm,
                            env_state, last_obs)

    def _train_epoch_graphed(self, ts: V2PTrainState, draws: Optional[Dict] = None
                             ) -> Tuple[V2PTrainState, Dict[str, torch.Tensor]]:
        """`train_epoch` with each env step and each optimizer step one call
        of a `StaticGraph` (replayed from a CUDA graph on the card; on the CPU
        the same staged steps run as they are). The draws, the last value,
        GAE, the running norms and the metrics stay eager; the draws come
        from the generators in the eager epoch's order, so both epochs take
        the same. The returned env state and last obs are copies of the
        static ones. The epoch's randomized env (`epoch_env`) is made eager,
        kept as `last_env`, and its constants copied into the static env
        the graphs step. The phases are the tracer's spans
        (``utils/trace.py``); the reset is the step's `masked_reset` part."""
        with trace.tracer.epoch(ts.epoch, self.device):
            env = self.epoch_env(ts, draws)
            self.last_env = env
            with trace.span("rollout"):
                traj, env_state, last_obs = self._rollout_graphed(ts, draws, env)
            with trace.span("prepare"):
                batch_all, obs_norm_next, val_norm, lr = self._prepare(ts, traj)
            with trace.span("update"):
                stat_means, lr, opt = self._update_graphed(ts, batch_all, lr, draws)
            with trace.span("finish"):
                return self._finish(ts, traj, stat_means, lr, opt, obs_norm_next, val_norm,
                                    PM.tree_map(torch.clone, env_state), last_obs.clone())

    def _prepare(self, ts: V2PTrainState, traj):
        """GAE, the running norms and the epoch's samples: (the batch, env-
        major (T·N, ...); the obs norm for the next epoch; this epoch's value
        norm; this epoch's lr)."""
        cfg, dev = self.cfg, self.device
        advs = self._gae(traj)
        returns = advs + traj["value"]

        T, N = cfg.horizon, self.env.cfg.num_envs
        B = T * N          # this rank's samples (the JAX learner's local_B)
        collective = self.mesh is not None and self.mesh.collective

        def flat(x):
            """(T, N, ...) → (N·T, ...), env-major: this rank's row of the
            JAX learner's (dp, local_B) layout."""
            return x.transpose(0, 1).reshape((B,) + x.shape[2:])

        obs_f = flat(traj["obs"])
        # running obs stats take effect NEXT epoch; this epoch trains with
        # the stats the rollout used
        obs_norm_next = RN.update(ts.obs_norm, obs_f, self.mesh)
        val_norm = RN.update(ts.val_norm, returns.reshape(-1, 1), self.mesh) \
            if cfg.normalize_value else ts.val_norm
        ret_f = flat(returns)
        ret_norm_f = RN.normalize_value(val_norm, ret_f[:, None])[:, 0] \
            if cfg.normalize_value else ret_f
        adv_f = flat(advs)
        if cfg.normalize_advantage:
            if collective:
                # the global batch's mean and population std
                n_all = B * self.dp
                mean = self._sum(adv_f.sum()) / n_all
                std = torch.sqrt(self._sum(((adv_f - mean) ** 2).sum()) / n_all)
            else:
                mean, std = adv_f.mean(), adv_f.std(unbiased=False)
            adv_f = (adv_f - mean) / (std + 1e-8)
        batch_all = dict(obs=obs_f, action=flat(traj["action"]), old_mu=flat(traj["mu"]),
                         old_neglogp=flat(traj["neglogp"]), adv=adv_f, return_norm=ret_norm_f,
                         lane=flat(self._lane[None].expand(T, N)))

        lr = ts.lr
        if cfg.lr_schedule == "linear":
            frac = np.float32(1.0) - np.float32(ts.epoch) / np.float32(cfg.lr_decay_epochs)
            lr = cfg.learning_rate * torch.clamp(torch.tensor(frac, device=dev),
                                                 cfg.lr_min_frac, 1.0)
        return batch_all, obs_norm_next, val_norm, lr

    def _update_eager(self, ts: V2PTrainState, batch_all, lr, draws):
        """The mini-epochs op by op: (the steps' mean stats with `grad_skip`,
        the last lr, the Adam state)."""
        cfg, dev = self.cfg, self.device
        B = cfg.horizon * self.env.cfg.num_envs
        collective = self.mesh is not None and self.mesh.collective
        plist = list(ts.params.values())
        opt = ts.opt_state
        mb = self.mb_local
        stats_rows = []
        for e in range(cfg.mini_epochs):
            perm = _shard_perm(draws, e, B, ts.generator, self.dp, self.rank, dev)
            for i in range(self.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in batch_all.items()}
                loss, stats = self._loss(ts.params, batch, ts.obs_norm,
                                         mb * self.dp if collective else None)
                grads = torch.autograd.grad(loss, plist)
                svals = torch.stack([v.detach() for v in stats.values()])
                if collective:
                    # the global gradient and stats in one flat bucket: the
                    # guard below sees the same gradient on every rank
                    *grads, svals = PM.flat_all_reduce(list(grads) + [svals], self.mesh)
                opt, ok = _guarded_adam_step(plist, opt, grads, lr, cfg.grad_norm)
                lr = self._adapt_lr(lr, svals[STAT_NAMES.index("kl")])
                stats_rows.append(torch.cat([svals, (~ok).float()[None]]))
        return torch.stack(stats_rows).mean(0), lr, opt

    def _finish(self, ts: V2PTrainState, traj, stat_means, lr, opt, obs_norm_next, val_norm,
                env_state, last_obs):
        """The epoch's metrics and the new train state."""
        T = self.cfg.horizon
        metrics = dict(zip(STAT_NAMES + ("grad_skip",), stat_means))
        # the rollout's metrics over every rank's envs, in one collective
        ex = traj["extras"]
        sums = self._sum(torch.cat([
            torch.stack([x.sum().float() for x in (
                traj["reward"], traj["done"], ex["cycle_end"], ex["contact_now"],
                ex["cycle_hit"], ex["contact_est_in"], ex["swing_fh"], ex["swing_bh"])]),
            traj["sub_rewards"].sum((0, 1))]))
        n_all = self.num_envs_global
        metrics["reward_mean"] = sums[0] / (T * n_all)
        metrics["episode_return"] = sums[0] / n_all
        metrics["done_rate"] = sums[1] / (T * n_all)
        for i, name in enumerate(("pos_reward", "ball_pos_reward", "quality_reward",
                                  "swing_speed_reward")[:sums.shape[0] - 8]):
            metrics[name] = sums[8 + i] / (T * n_all)
        metrics["lr"] = torch.as_tensor(lr, device=self.device)
        # behavioral instrumentation: is it swinging, hitting, landing in?
        n_cyc, n_contact = sums[2], sums[3]
        metrics["cycles"] = n_cyc
        metrics["hit_rate"] = sums[4] / torch.clamp_min(n_cyc, 1)
        metrics["contact_rate"] = n_contact / (T * n_all)
        metrics["est_bounce_in_rate"] = sums[5] / torch.clamp_min(n_contact, 1)
        metrics["fh_ratio"] = sums[6] / torch.clamp_min(n_cyc, 1)
        metrics["bh_ratio"] = sums[7] / torch.clamp_min(n_cyc, 1)
        # median and P90 over in-reaction, court-gated frames (NaN marks the
        # others), of every rank's envs
        rbd = PM.all_gather_rows(ex["racket_ball_dist"], self.mesh).reshape(-1)
        metrics["racket_ball_dist"] = nanmedian(rbd)
        metrics["racket_ball_dist_p90"] = torch.nanquantile(rbd, 0.9)

        new_ts = V2PTrainState(params=ts.params, opt_state=opt, obs_norm=obs_norm_next,
                               val_norm=val_norm, env_state=env_state, last_obs=last_obs,
                               generator=ts.generator, epoch=ts.epoch + 1,
                               lr=metrics["lr"])
        return new_ts, metrics

    # -- the graphed epoch ------------------------------------------------------

    def _statics(self, ts: V2PTrainState) -> SimpleNamespace:
        """The graphed epoch's static tensors and its two `StaticGraph`s:
        `step` (one env step) and `update` (one optimizer step). Made at the
        first call, and anew when the horizon, the env count or the
        minibatches change. `env` is the env the step graph steps: this
        learner's, or under model or ball randomization a copy whose
        randomized constants are its own (``envs/domain_rand.py``
        `static_env`); `dr_act`, `dr_obs` the step's noise of each action
        and obs spec."""
        cfg, env, dev = self.cfg, self.env, self.device
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        shape = (T, N, cfg.mini_epochs, self.num_minibatches, self.mb_local)
        if self._st is not None and self._st.shape == shape:
            return self._st
        self._st = None                       # the old graphs' pools go first
        traj = dict(obs=torch.empty(T, N, self.obs_dim, device=dev),
                    action=torch.empty(T, N, A, device=dev),
                    mu=torch.empty(T, N, A, device=dev),
                    sub_rewards=torch.empty(T, N, env.num_sub_rewards, device=dev),
                    extras={k: torch.empty(T, N, device=dev) for k in env.EXTRAS})
        for k in ("neglogp", "value", "reward", "done", "terminate"):
            traj[k] = torch.empty(T, N, device=dev)
        steps = cfg.mini_epochs * self.num_minibatches
        dr = env.randomizer
        st = SimpleNamespace(
            shape=shape, env=env if dr is None else dr.static_env(env),
            state=PM.tree_map(torch.clone, ts.env_state), obs=ts.last_obs.clone(),
            obs_norm=RN.RunningNormState.create(self.obs_dim, dev),
            val_norm=RN.RunningNormState.create(1, dev),
            # the step's draws, shaped by a throwaway generator's
            draws=env.step_draws(torch.Generator(dev)), noise=torch.empty(N, A, device=dev),
            traj=traj, row=torch.zeros(1, dtype=torch.long, device=dev),
            batch=None, idx=torch.empty(self.mb_local, dtype=torch.long, device=dev),
            lr=torch.zeros((), device=dev), count=torch.zeros((), dtype=torch.int32, device=dev),
            stats=torch.empty(steps, len(STAT_NAMES) + 1, device=dev),
            params=None, opt=None)
        st.dr_act, st.dr_obs = ([], []) if dr is None else dr.step_noise_statics(
            (N, A), (N, self.obs_dim), dev)
        st.step = graphs.StaticGraph(self._graphed_step, dev, "step")
        st.update = graphs.StaticGraph(self._graphed_update, dev, "update")
        self._st = st
        return st

    def _step_key(self, params, env=None) -> tuple:
        """The `step` graph's key for stepping `env` (this learner's unless
        given): the addresses of what it reads in place (the params; every
        lane's MVAE decoder and stats and frozen π_low; the env's model,
        ball pool, init frames, body channel and per-env hand, grip and
        two-hand arrays; the two-hand IK's rest pose; the dual env's lane
        swap, lanes, mirror and serve box; ball constants held as tensors)
        and the env's constants the capture bakes in (its config, the ball
        constants held as floats, the contact constants)."""
        env = self.env if env is None else env
        held = list(params.values()) + [self.sigma, self._lane]
        for obj in env._lane_specs + (env.pi_low, env.pi_low_b):
            held += _held_tensors(obj)
        gen = env.gen
        held += PM.tree_leaves(env.model) + [
            gen.traj_pool, gen.launch_pos, gen.launch_vel, gen.launch_vspin, gen.x_order,
            env.init_conditions, env.motion_bodies]
        held += [getattr(env, f) for f in env._ENV_FIELDS]
        if env.any_two_hand:
            held.append(env.rest_joints_smpl)
        if isinstance(env, DualTennisEnv):
            held += [env._swap, env._lane, env._mirror, env._serve_lo, env._serve_hi]
        ball = tuple(v for v in env.ball_params if not isinstance(v, torch.Tensor))
        held += [v for v in env.ball_params if isinstance(v, torch.Tensor)] + [env._gvec]
        return (graphs.tensor_key(held), env.cfg, ball, env.contact_params,
                id(env), id(env.pi_low), id(env.pi_low_b))

    @torch.no_grad()
    def _rollout_graphed(self, ts: V2PTrainState, draws: Optional[Dict] = None,
                         env: Optional[TennisEnv] = None):
        """The rollout with each step one call of the `step` graph; the draws,
        the randomization's scheduled noise and the last value eager. `env`
        (this learner's unless given: an epoch's randomized copy) has its
        randomized constants copied into the static env the graph steps.
        Returns the static trajectory, env state and last obs, which the
        next call overwrites."""
        cfg, dev = self.cfg, self.device
        env = self.env if env is None else env
        T = cfg.horizon
        st = self._statics(ts)
        dr = self.env.randomizer
        if st.env is not self.env:
            dr.refresh_env(st.env, env)
        graphs.refresh(PM.tree_leaves((st.state, st.obs, st.obs_norm, st.val_norm)),
                       PM.tree_leaves((ts.env_state, ts.last_obs, ts.obs_norm, ts.val_norm)))
        st.params = ts.params
        st.row.zero_()
        key = self._step_key(ts.params, st.env)
        dr_step = ts.epoch * cfg.horizon
        for t in range(T):
            # the eager step's draws: the env's from its generator; from the
            # train state's, the policy noise, then each action spec's and
            # each obs spec's
            if draws is None:
                _copy_draws(st.draws, env.step_draws())
                torch.randn(st.noise.shape, generator=ts.generator, device=dev, out=st.noise)
            else:
                _copy_draws(st.draws, draws["env"][t])
                st.noise.copy_(as_draw(draws["noise"][t], torch.float32, dev))
            if dr is not None:
                dr.draw_step_noise(st.dr_act, st.dr_obs, dr_step, ts.generator,
                                   *(None if draws is None or k not in draws else draws[k][t]
                                     for k in ("dr_act", "dr_obs")))
            st.step(key)
        traj = dict(st.traj)
        _, vn_last = self._forward(ts.params, ts.obs_norm, st.obs)
        v_next = torch.cat([traj["value"][1:], self._value(ts, vn_last)[None]], dim=0)
        traj["next_value"] = v_next * (1.0 - traj["terminate"])
        return traj, st.state, st.obs

    def _graphed_step(self) -> None:
        """One env step on the static tensors: the policy on the static obs,
        the static noise, the randomization's static action noise, the
        static env's `step` on the static draws, its static obs noise, the
        trajectory's row `row`, the new state and obs copied back."""
        st = self._st
        dr = self.env.randomizer
        with torch.no_grad():
            with trace.part("policy"):
                mu, v_norm = self._forward(st.params, st.obs_norm, st.obs)
                action = mu + self.sigma[None] * st.noise
                env_action = action if dr is None else dr.apply_noise(action, dr.act_specs,
                                                                      st.dr_act)
            with trace.part("env"):
                state, out = st.env.step(st.state, env_action, st.draws)
            with trace.part("record"):
                row = dict(obs=st.obs, action=action, mu=mu,
                           neglogp=diag_gaussian_neglogp(action, mu, self.sigma[None]),
                           value=self._value(st, v_norm),
                           # a diverged env's last reward can be non-finite
                           reward=torch.where(torch.isfinite(out.reward), out.reward, 0.0),
                           done=out.done.float(), terminate=out.terminate.float(),
                           sub_rewards=out.sub_rewards)
                for k, v in row.items():
                    st.traj[k].index_copy_(0, st.row, v[None])
                if out.extras.keys() != st.traj["extras"].keys():
                    raise ValueError(f"the step's extras {sorted(out.extras)} are not the env's "
                                     f"EXTRAS {sorted(st.traj['extras'])}")
                for k, v in out.extras.items():
                    st.traj["extras"][k].index_copy_(0, st.row, v[None])
                st.row.add_(1)
                obs = out.obs if dr is None else dr.apply_noise(out.obs, dr.obs_specs, st.dr_obs)
                graphs.refresh(PM.tree_leaves((st.state, st.obs)), PM.tree_leaves((state, obs)))

    def _update_graphed(self, ts: V2PTrainState, batch_all, lr, draws):
        """The mini-epochs with each optimizer step one call of the `update`
        graph: (the steps' mean stats with `grad_skip`, the last lr, the Adam
        state)."""
        cfg, st = self.cfg, self._st
        B = cfg.horizon * self.env.cfg.num_envs
        mb = self.mb_local
        if st.batch is None:
            st.batch = {k: v.clone() for k, v in batch_all.items()}
        else:
            graphs.refresh(list(st.batch.values()), [batch_all[k] for k in st.batch])
        st.lr.copy_(lr)
        st.count.copy_(ts.opt_state.count)
        st.params, st.opt = ts.params, ts.opt_state
        st.row.zero_()
        key = graphs.tensor_key(list(ts.params.values()) + ts.opt_state.mu + ts.opt_state.nu)
        for e in range(cfg.mini_epochs):
            perm = _shard_perm(draws, e, B, ts.generator, 1, 0, self.device)
            for i in range(self.num_minibatches):
                st.idx.copy_(perm[i * mb:(i + 1) * mb])
                st.update(key)
        opt = AdamState(count=st.count.clone(), mu=ts.opt_state.mu, nu=ts.opt_state.nu)
        return st.stats.mean(0), st.lr.clone(), opt

    def _graphed_update(self) -> None:
        """One optimizer step on the static tensors: the minibatch gathered
        through `idx`, the loss and its gradient, the guarded optax-chain
        Adam on `count` and `lr`, the adaptive lr, the stats' row `row`."""
        st, cfg = self._st, self.cfg
        plist = list(st.params.values())
        with trace.part("gather"):
            batch = {k: v[st.idx] for k, v in st.batch.items()}
        with trace.part("forward"):
            loss, stats = self._loss(st.params, batch, st.obs_norm)
        with trace.part("backward"):
            grads = torch.autograd.grad(loss, plist)
        with torch.no_grad(), trace.part("optimizer"):
            svals = torch.stack([v.detach() for v in stats.values()])
            opt, ok = _guarded_adam_step(plist, AdamState(st.count, st.opt.mu, st.opt.nu),
                                         grads, st.lr, cfg.grad_norm)
            st.count.copy_(opt.count)
            if cfg.lr_schedule == "adaptive":
                st.lr.copy_(self._adapt_lr(st.lr, svals[STAT_NAMES.index("kl")]))
            st.stats.index_copy_(0, st.row, torch.cat([svals, (~ok).float()[None]])[None])
            st.row.add_(1)


def _held_tensors(obj) -> list:
    """The tensors an env part holds: a module's parameters and buffers, a
    dataclass's fields (modules and running norms included)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _held_tensors(getattr(obj, f.name))]
    return []


def _copy_draws(static: Dict, draws: Dict) -> None:
    """Copy one step's draws (tensors or numpy arrays, nested like
    `TennisEnv.step_draws`) into the static ones, key by key."""
    for k, s in static.items():
        if isinstance(s, dict):
            _copy_draws(s, draws[k])
        else:
            s.copy_(as_draw(draws[k], s.dtype, s.device))
