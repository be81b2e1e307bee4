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
can feed the JAX learner's.

`save_checkpoint` writes, and `load_checkpoint` reads, the JAX package's
`V2PPPO.save_checkpoint` `.npz` (stacked leaves included);
`load_stage_checkpoint` is the curriculum's warm start with the JAX
package's surgery. Not ported yet (they raise): device meshes and per-chip
minibatches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..envs.tennis import TennisEnv
from ..utils.runtime import as_draw, resolve_device
from . import running_norm as RN
from .networks import V2PNet
from .optim import AdamState, clip_adam_apply, init_adam
from .ppo import PPOConfig, diag_gaussian_neglogp, policy_kl, resolve_compute_dtype


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
        if mesh is not None or cfg.minibatch_per_chip:
            raise NotImplementedError("device meshes and per-chip minibatches are not ported yet")
        if cfg.num_policies < 1:
            raise ValueError(f"num_policies {cfg.num_policies}")
        self.device = resolve_device(device)
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
        nbatch = env.cfg.num_envs * cfg.horizon
        if nbatch % cfg.minibatch_size:
            raise ValueError(f"batch {nbatch} not divisible by minibatch {cfg.minibatch_size}")
        self.num_minibatches = nbatch // cfg.minibatch_size
        # the env the last epoch stepped (a randomized copy under DR)
        self.last_env = env

    def _initial_params(self) -> Dict[str, torch.Tensor]:
        if self.num_policies == 1:
            return dict(self.net.named_parameters())
        named = [dict(n.named_parameters()) for n in self.nets]
        return {k: torch.stack([d[k] for d in named]) for k in named[0]}

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None,
                   reset_draws: Optional[Dict] = None) -> V2PTrainState:
        """A fresh train state: the networks' initial params unless `params`
        is given (with num_policies > 1, leaves stacked on a leading policy
        axis), and a reset of every env (from the env's generator unless
        `reset_draws` is given)."""
        src = params if params is not None else self._initial_params()
        if self.num_policies > 1:
            bad = [k for k, v in src.items() if v.shape[0] != self.num_policies]
            if bad:
                raise ValueError(f"params {bad} lack the leading axis of {self.num_policies} "
                                 "policies")
        params = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                  for k, v in src.items()}
        env_state, obs = self.env.reset_all(reset_draws)
        return V2PTrainState(
            params=params,
            opt_state=init_adam(list(params.values()), self.compute_dtype),
            obs_norm=RN.RunningNormState.create(self.obs_dim, self.device),
            val_norm=RN.RunningNormState.create(1, self.device),
            env_state=env_state, last_obs=obs,
            generator=torch.Generator(self.device).manual_seed(self.seed),
            epoch=0, lr=torch.tensor(self.cfg.learning_rate, device=self.device))

    def save_checkpoint(self, path: str, ts: V2PTrainState) -> None:
        """Write params, running stats, Adam state, epoch and lr to one
        `.npz` in the JAX learner's layout; the env state is not saved (a
        resume resets the envs, as in the JAX learner)."""
        from ..utils import checkpoint as CK

        CK.save_npz(path, CK.learner_state_to_jax(ts.params, ts.opt_state, ts.obs_norm,
                                                  ts.val_norm, ts.epoch, ts.lr))

    def load_checkpoint(self, path: str, reset_draws: Optional[Dict] = None) -> V2PTrainState:
        """Train state from a JAX-package `V2PPPO.save_checkpoint` `.npz`
        (params, Adam state, running stats, epoch, and lr under the adaptive
        schedule); with num_policies > 1 its leaves carry the policy axis.
        The env state is a fresh reset."""
        from ..utils import checkpoint as CK

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

        params = self._initial_params()
        like = CK.learner_state_to_jax(
            params, init_adam(list(params.values())),
            RN.RunningNormState.create(self.obs_dim), RN.RunningNormState.create(1),
            0, torch.tensor(self.cfg.learning_rate))
        return self._state_from_flat(CK.load_with_surgery(path, like, {"var": 1.0}),
                                     reset_draws)

    def _state_from_flat(self, flat, reset_draws) -> V2PTrainState:
        from ..utils import checkpoint as CK

        ts = self.init_state(CK.params_from_jax(flat), reset_draws)
        ts.opt_state, ts.obs_norm, ts.val_norm, ts.epoch, lr = CK.learner_state_from_jax(
            flat, list(ts.params), self.device, self.compute_dtype)
        if self.cfg.lr_schedule == "adaptive":
            ts.lr = torch.tensor(lr, device=self.device)
        return ts

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
        sel = torch.nn.functional.one_hot(lane, self.num_policies).T.to(outs[0][0].dtype)
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

    @torch.no_grad()
    def rollout(self, ts: V2PTrainState, draws: Optional[Dict] = None,
                env: Optional[TennisEnv] = None):
        """`horizon` steps from the carried env state; returns the (T, N, ...)
        trajectory with the terminate-masked next values, the new env state
        and the last obs. `env` is the env to step (this learner's unless
        given: an epoch's randomized copy)."""
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
        for t in range(T):
            mu, v_norm = self._forward(ts.params, ts.obs_norm, obs)
            if draws is None:
                noise = torch.randn(mu.shape, generator=ts.generator, device=dev)
            else:
                noise = as_draw(draws["noise"][t], torch.float32, dev)
            action = mu + self.sigma[None] * noise
            # randomization's action noise goes on what the env executes;
            # the stored action stays the policy's
            env_action = action
            if dr is not None and dr.act_specs:
                env_action = dr.randomize_actions(action, dr_step, ts.generator,
                                                  None if draws is None else draws["dr_act"][t])
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
                                       None if draws is None else draws["dr_obs"][t])
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

    def _loss(self, params, mb, obs_norm):
        cfg = self.cfg
        mu, v_norm = self._forward(params, obs_norm, mb["obs"], mb["lane"])
        sigma = self.sigma[None]
        neglogp = diag_gaussian_neglogp(mb["action"], mu, sigma)
        ratio = torch.exp(mb["old_neglogp"] - neglogp)
        surr1 = mb["adv"] * ratio
        surr2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = torch.maximum(-surr1, -surr2).mean()
        c_loss = ((v_norm - mb["return_norm"]) ** 2).mean()
        b_loss = ((torch.clamp_min(mu - 1.0, 0.0) ** 2
                   + torch.clamp_max(mu + 1.0, 0.0) ** 2).sum(-1)).mean()
        # aux: residual dof close to 0
        nl = self.env.cfg.num_latents
        aux = (mu[:, nl:nl + 3] ** 2).sum(-1).mean() if self.env.cfg.add_residual_dof else 0.0
        loss = (a_loss + cfg.critic_coef * c_loss + cfg.bounds_loss_coef * b_loss
                + cfg.aux_dof_res_coef * aux)
        kl = policy_kl(mu, sigma, mb["old_mu"], sigma).mean()
        return loss, dict(a_loss=a_loss, c_loss=c_loss, b_loss=b_loss, kl=kl)

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
        model = dr.randomize_model(env.model, step, ts.generator,
                                   None if draws is None else draws["dr_model"]) \
            if dr.model_specs else None
        ball = dr.randomize_ball(env.ball_params, step, ts.generator,
                                 None if draws is None else draws["dr_ball"], device=self.device) \
            if dr.ball_specs else None
        return env.with_model(model, ball)

    def train_epoch(self, ts: V2PTrainState, draws: Optional[Dict] = None
                    ) -> Tuple[V2PTrainState, Dict[str, torch.Tensor]]:
        """One epoch. `draws` (optional) holds `noise` (T, N, A), `perms`
        (mini_epochs, T·N) and `env` (T per-step draw dicts of
        `TennisEnv.step`) in place of the generators' draws; under domain
        randomization also `dr_model`, `dr_ball`, `dr_act` (T, per action
        spec (N, A)) and `dr_obs` (T, per obs spec (N, obs_dim)) as standard
        draws. Params and Adam moments are updated in place; returns the new
        state and the metrics as 0-d tensors on the device; the env the epoch
        stepped is kept as `last_env`."""
        cfg, dev = self.cfg, self.device
        env = self.epoch_env(ts, draws)
        self.last_env = env
        traj, env_state, last_obs = self.rollout(ts, draws, env)
        advs = self._gae(traj)
        returns = advs + traj["value"]

        T, N = cfg.horizon, self.env.cfg.num_envs
        B = T * N

        def flat(x):
            """(T, N, ...) → (N·T, ...), env-major."""
            return x.transpose(0, 1).reshape((B,) + x.shape[2:])

        obs_f = flat(traj["obs"])
        # running obs stats take effect NEXT epoch; this epoch trains with
        # the stats the rollout used
        obs_norm_next = RN.update(ts.obs_norm, obs_f)
        val_norm = RN.update(ts.val_norm, returns.reshape(-1, 1)) \
            if cfg.normalize_value else ts.val_norm
        ret_f = flat(returns)
        ret_norm_f = RN.normalize_value(val_norm, ret_f[:, None])[:, 0] \
            if cfg.normalize_value else ret_f
        adv_f = flat(advs)
        if cfg.normalize_advantage:
            adv_f = (adv_f - adv_f.mean()) / (adv_f.std(unbiased=False) + 1e-8)
        batch_all = dict(obs=obs_f, action=flat(traj["action"]), old_mu=flat(traj["mu"]),
                         old_neglogp=flat(traj["neglogp"]), adv=adv_f, return_norm=ret_norm_f,
                         lane=flat(self._lane[None].expand(T, N)))

        lr = ts.lr
        if cfg.lr_schedule == "linear":
            frac = np.float32(1.0) - np.float32(ts.epoch) / np.float32(cfg.lr_decay_epochs)
            lr = cfg.learning_rate * torch.clamp(torch.tensor(frac, device=dev),
                                                 cfg.lr_min_frac, 1.0)

        names = list(ts.params)
        plist = [ts.params[k] for k in names]
        opt = ts.opt_state
        mb = cfg.minibatch_size
        stats_rows = []
        for e in range(cfg.mini_epochs):
            if draws is None:
                perm = torch.randperm(B, generator=ts.generator, device=dev)
            else:
                perm = as_draw(draws["perms"][e], torch.long, dev)
            for i in range(self.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in batch_all.items()}
                loss, stats = self._loss(ts.params, batch, ts.obs_norm)
                grads = torch.autograd.grad(loss, plist)
                opt, ok = _guarded_adam_step(plist, opt, grads, lr, cfg.grad_norm)
                stats["grad_skip"] = (~ok).float()
                lr = self._adapt_lr(lr, stats["kl"].detach())
                stats_rows.append(torch.stack([v.detach() for v in stats.values()]))

        metrics = dict(zip(stats.keys(), torch.stack(stats_rows).mean(0)))
        metrics["reward_mean"] = traj["reward"].mean()
        metrics["episode_return"] = traj["reward"].sum(0).mean()
        metrics["done_rate"] = traj["done"].mean()
        subs = traj["sub_rewards"].mean((0, 1))
        for i, name in enumerate(("pos_reward", "ball_pos_reward", "quality_reward",
                                  "swing_speed_reward")[:subs.shape[-1]]):
            metrics[name] = subs[i]
        metrics["lr"] = torch.as_tensor(lr, device=dev)
        # behavioral instrumentation: is it swinging, hitting, landing in?
        ex = traj["extras"]
        n_cyc = ex["cycle_end"].sum()
        n_contact = ex["contact_now"].sum()
        metrics["cycles"] = n_cyc
        metrics["hit_rate"] = ex["cycle_hit"].sum() / torch.clamp_min(n_cyc, 1)
        metrics["contact_rate"] = ex["contact_now"].mean()
        metrics["est_bounce_in_rate"] = ex["contact_est_in"].sum() / torch.clamp_min(n_contact, 1)
        metrics["fh_ratio"] = ex["swing_fh"].sum() / torch.clamp_min(n_cyc, 1)
        metrics["bh_ratio"] = ex["swing_bh"].sum() / torch.clamp_min(n_cyc, 1)
        # median and P90 over in-reaction, court-gated frames (NaN marks the
        # others)
        rbd = ex["racket_ball_dist"]
        metrics["racket_ball_dist"] = nanmedian(rbd)
        metrics["racket_ball_dist_p90"] = torch.nanquantile(rbd.reshape(-1), 0.9)

        new_ts = V2PTrainState(params=ts.params, opt_state=opt, obs_norm=obs_norm_next,
                               val_norm=val_norm, env_state=env_state, last_obs=last_obs,
                               generator=ts.generator, epoch=ts.epoch + 1,
                               lr=metrics["lr"])
        return new_ts, metrics
