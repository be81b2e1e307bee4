"""PPO actor-learner for the imitation env (PyTorch counterpart of
``learn/ppo.py``).

One `train_epoch` = reset → horizon-step rollout (policy + env step) → GAE →
mini_epochs × minibatch gradient steps over shuffled minibatches. Everything
stays on the device; nothing in an epoch waits for the host.

Semantics preserved from the JAX learner:
- per-step next-value bootstrap `next_vals·(1−terminated)`, carried from the
  next step's forward instead of a second forward per step
- alive mask = envs not yet done, applied to all losses
- advantage normalized over alive samples; GAE with per-step next values
- fixed log-sigma, residual action mu += target dof
- running obs norm (updated once per epoch, taking effect NEXT epoch) and
  value normalization
- lr schedules: constant, adaptive (per-minibatch KL controller), linear
- the optimizer step as the optax-chain path (``learn/optim.py``) or, with
  `fused_optimizer="on"`, the fused K1 kernel (``ops/fused_adam.py``)

The random draws of an epoch (reset times, action noise, minibatch
permutations) come from the train state's generator, or from `draws=` so a
test can feed the JAX learner's draws.

Not ported yet: the context-IK path, multi-device meshes, per-chip
minibatches and local-SGD sync; asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..envs.humanoid_im import HumanoidImEnv
from ..ops.fused_adam import fused_clip_adam_apply
from ..utils.runtime import resolve_device
from . import running_norm as RN
from .networks import ImitatorNet
from .optim import AdamState, clip_adam_apply, init_adam


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32
    mini_epochs: int = 6
    minibatch_size: int = 512
    learning_rate: float = 2e-5
    gamma: float = 0.99
    tau: float = 0.95
    e_clip: float = 0.2
    critic_coef: float = 5.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0
    grad_norm: float = 50.0
    sigma_init: float = -1.756
    normalize_value: bool = True
    normalize_advantage: bool = True
    obs_clip: float = 5.0
    lr_schedule: str = "constant"          # constant | adaptive | linear
    kl_threshold: float = 0.008
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    lr_decay_epochs: int = 2000
    lr_min_frac: float = 0.05
    # not ported yet: must keep these defaults
    minibatch_per_chip: bool = False
    dp_sync: str = "per_minibatch"
    use_context_ik: bool = False
    aux_w_dof: float = 1.0
    aux_w_pos: float = 10.0
    # MLP-trunk compute dtype: "auto" = bfloat16 on the card (with bf16 Adam
    # moments), float32 on the CPU
    compute_dtype: str = "auto"            # auto | f32 | bf16
    # "on": the fused clip+Adam kernel K1; "auto"/"off": the optax-chain path
    fused_optimizer: str = "auto"          # auto(=off) | on | off


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    obs_norm: RN.RunningNormState
    val_norm: RN.RunningNormState
    generator: torch.Generator
    epoch: int
    lr: torch.Tensor


def resolve_compute_dtype(name: str, device: torch.device) -> torch.dtype:
    """"auto" -> bfloat16 on any device but the CPU, float32 on the CPU."""
    if name == "auto":
        return torch.float32 if device.type == "cpu" else torch.bfloat16
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def diag_gaussian_neglogp(actions, mu, sigma):
    d = actions.shape[-1]
    return (0.5 * torch.sum(((actions - mu) / sigma) ** 2, dim=-1)
            + 0.5 * np.log(2 * np.pi) * d + torch.sum(torch.log(sigma), dim=-1))


def policy_kl(mu0, sigma0, mu1, sigma1):
    """Analytic KL(N0 || N1) per sample."""
    c1 = torch.log(sigma1 / sigma0 + 1e-8)
    c2 = (sigma0 ** 2 + (mu1 - mu0) ** 2) / (2.0 * sigma1 ** 2 + 1e-8)
    return torch.sum(c1 + c2 - 0.5, dim=-1)


class ImitationPPO:
    """Owns the env and the network; the training state flows through
    `init_state` / `train_epoch`."""

    def __init__(self, env: HumanoidImEnv, cfg: PPOConfig = PPOConfig(), seed: int = 7,
                 mesh=None, device=None):
        if (mesh is not None or cfg.use_context_ik or cfg.minibatch_per_chip
                or cfg.dp_sync != "per_minibatch"):
            raise NotImplementedError(
                "device meshes, context IK, per-chip minibatches and local-SGD sync "
                "are not ported yet")
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, learner on {self.device}")
        self.env = env
        self.cfg = cfg
        self.seed = seed
        self.num_actions = env.num_actions
        self.obs_dim = 734
        self.compute_dtype = resolve_compute_dtype(cfg.compute_dtype, self.device)
        # initialized on the CPU from a seeded CPU generator, then moved, so
        # the initial params are the same on every device
        self.net = ImitatorNet(num_actions=self.num_actions, obs_dim=self.obs_dim,
                               dtype=self.compute_dtype,
                               generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.use_fused = cfg.fused_optimizer == "on"
        self.sigma = torch.full((self.num_actions,), float(np.exp(cfg.sigma_init)),
                                device=self.device)

        nbatch = env.cfg.num_envs * cfg.horizon
        if nbatch % cfg.minibatch_size:
            raise ValueError(f"batch {nbatch} not divisible by minibatch {cfg.minibatch_size}")
        self.num_minibatches = nbatch // cfg.minibatch_size

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh train state (the network's initial params unless `params`
        is given); two calls give independent, identical states."""
        src = params if params is not None else dict(self.net.named_parameters())
        params = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                  for k, v in src.items()}
        return TrainState(
            params=params,
            opt_state=init_adam(list(params.values()), self.compute_dtype),
            obs_norm=RN.RunningNormState.create(self.obs_dim, self.device),
            val_norm=RN.RunningNormState.create(1, self.device),
            generator=torch.Generator(self.device).manual_seed(self.seed),
            epoch=0,
            lr=torch.tensor(self.cfg.learning_rate, device=self.device),
        )

    def load_checkpoint(self, path: str) -> TrainState:
        """Train state from a JAX-package `.npz` checkpoint (params, running
        stats, Adam state, epoch, lr)."""
        from ..utils import checkpoint as CK

        flat = CK.load_npz(path)
        ts = self.init_state(CK.params_from_jax(flat))
        mu, nu, count = CK.adam_state_from_jax(flat)
        names = list(ts.params)
        ts.opt_state = AdamState(
            count=torch.as_tensor(count, dtype=torch.int32, device=self.device),
            mu=[torch.as_tensor(mu[k], device=self.device).to(self.compute_dtype) for k in names],
            nu=[torch.as_tensor(nu[k], device=self.device).to(self.compute_dtype) for k in names])
        ts.obs_norm = CK.running_norm_from_jax(flat, "obs_norm", self.device)
        ts.val_norm = CK.running_norm_from_jax(flat, "val_norm", self.device)
        ts.epoch = int(flat["epoch"])
        if self.cfg.lr_schedule == "adaptive":
            ts.lr = torch.tensor(float(flat["lr"]), device=self.device)
        return ts

    # -- policy forward -------------------------------------------------------

    def _ctx_frame(self, ctx_feat, t: int):
        """Context frame at rollout step t (index pad + t). Feature layout:
        [obs_pos 72 | rot 96 | dof 69 | pos_gt 72 | dof_gt 69]."""
        f = ctx_feat[:, self.env.cfg.context_padding + t]
        N = f.shape[0]
        return f[:, :72].reshape(N, 24, 3), f[:, 72:168].reshape(N, 24, 4), f[:, 168:237]

    def _apply(self, params, io_n):
        return functional_call(self.net, params, (io_n,))

    def _forward(self, params, obs_norm, raw_obs, ctx_feat, t: int):
        """raw env obs + context → (imitation_obs, normalized_obs, mu,
        value_norm, target_dof); mu includes the residual action."""
        cb_pos, cb_rot, c_dof = self._ctx_frame(ctx_feat, t)
        io = self.env.imitation_obs(raw_obs, cb_pos, cb_rot, c_dof)
        io_n = RN.normalize(obs_norm, io, self.cfg.obs_clip)
        mu, value = self._apply(params, io_n)
        mu = torch.cat([mu[:, :69] + c_dof, mu[:, 69:]], dim=-1)
        return io, io_n, mu, value, c_dof

    def _value(self, ts: TrainState, v_norm):
        if not self.cfg.normalize_value:
            return v_norm
        return RN.unnormalize_value(ts.val_norm, v_norm[:, None])[:, 0]

    # -- rollout --------------------------------------------------------------

    @torch.no_grad()
    def rollout(self, ts: TrainState, draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Reset every env, play `horizon` steps; returns the (T, N, ...)
        trajectory with the terminate-masked next values."""
        cfg, env = self.cfg, self.env
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        dev = self.device
        env_state, raw_obs, ctx = env.reset_all(
            generator=ts.generator,
            motion_times=None if draws is None else draws["motion_times"])
        ctx_feat = ctx["feat"]

        traj = dict(obs=torch.empty(T, N, self.obs_dim, device=dev),
                    action=torch.empty(T, N, A, device=dev),
                    mu=torch.empty(T, N, A, device=dev),
                    ctx_dof=torch.empty(T, N, 69, device=dev),
                    sub_rewards=torch.empty(T, N, 4, device=dev))
        for k in ("neglogp", "value", "reward", "done", "terminate", "alive"):
            traj[k] = torch.empty(T, N, device=dev)

        for t in range(T):
            io, _, mu, v_norm, c_dof = self._forward(ts.params, ts.obs_norm, raw_obs,
                                                     ctx_feat, t)
            if draws is None:
                noise = torch.randn(mu.shape, generator=ts.generator, device=dev)
            else:
                noise = torch.as_tensor(draws["noise"][t], device=dev)
            action = mu + self.sigma[None] * noise
            traj["alive"][t] = (env_state.reset_buf == 0).float()
            env_state, out = env.step(env_state, action)
            traj["obs"][t] = io
            traj["action"][t] = action
            traj["mu"][t] = mu
            traj["neglogp"][t] = diag_gaussian_neglogp(action, mu, self.sigma[None])
            traj["value"][t] = self._value(ts, v_norm)
            traj["reward"][t] = out.reward
            traj["done"][t] = out.done.float()
            traj["terminate"][t] = out.terminate.float()
            traj["sub_rewards"][t] = out.sub_rewards
            traj["ctx_dof"][t] = c_dof
            raw_obs = out.obs

        # v(obs_{t+1}) is the value computed at step t+1; one extra forward
        # for the final obs closes the horizon
        _, _, _, vn_last, _ = self._forward(ts.params, ts.obs_norm, raw_obs, ctx_feat, T)
        v_next = torch.cat([traj["value"][1:], self._value(ts, vn_last)[None]], dim=0)
        traj["next_value"] = v_next * (1.0 - traj["terminate"])
        return traj

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

    # -- update ---------------------------------------------------------------

    def _loss(self, params, batch, obs_norm):
        cfg = self.cfg
        io_n = RN.normalize(obs_norm, batch["obs"], cfg.obs_clip)
        mu_raw, v_norm = self._apply(params, io_n)
        mu = torch.cat([mu_raw[..., :69] + batch["ctx_dof"], mu_raw[..., 69:]], dim=-1)
        sigma = self.sigma[None]
        neglogp = diag_gaussian_neglogp(batch["action"], mu, sigma)

        ratio = torch.exp(batch["old_neglogp"] - neglogp)
        surr1 = batch["adv"] * ratio
        surr2 = batch["adv"] * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = torch.maximum(-surr1, -surr2)
        clipped = (torch.abs(ratio - 1.0) > cfg.e_clip).float()

        c_loss = (v_norm - batch["return_norm"]) ** 2

        soft_bound = 1.0
        b_loss = (torch.clamp_min(mu - soft_bound, 0.0) ** 2
                  + torch.clamp_max(mu + soft_bound, 0.0) ** 2).sum(-1)

        mask = batch["alive"]
        denom = torch.clamp_min(mask.sum(), 1.0)

        def masked(x):
            return (x * mask).sum() / denom

        loss = (masked(a_loss) + cfg.critic_coef * masked(c_loss)
                + cfg.bounds_loss_coef * masked(b_loss))
        kl = masked(policy_kl(mu, sigma, batch["old_mu"], sigma))
        stats = dict(a_loss=masked(a_loss), c_loss=masked(c_loss), b_loss=masked(b_loss),
                     clip_frac=masked(clipped), kl=kl)
        return loss, stats

    def _adapt_lr(self, lr, kl):
        cfg = self.cfg
        if cfg.lr_schedule != "adaptive":
            return lr
        return torch.where(kl > 2.0 * cfg.kl_threshold,
                           torch.clamp_min(lr / 1.5, cfg.min_lr),
                           torch.where(kl < 0.5 * cfg.kl_threshold,
                                       torch.clamp_max(lr * 1.5, cfg.max_lr), lr))

    # -- epoch ----------------------------------------------------------------

    def train_epoch(self, ts: TrainState, draws: Optional[Dict] = None
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One epoch. `draws` (optional) holds `motion_times` (N,), `noise`
        (T, N, A) and `perms` (mini_epochs, T·N) to use in place of the
        generator's draws. Returns the new state (params and moments are
        updated in place) and the metrics as 0-d tensors on the device."""
        cfg = self.cfg
        dev = self.device
        traj = self.rollout(ts, draws)
        advs = self._gae(traj)
        returns = advs + traj["value"]

        T, N = cfg.horizon, self.env.cfg.num_envs
        B = T * N

        def flat(x):
            """(T, N, ...) → (N·T, ...), env-major."""
            return x.transpose(0, 1).reshape((B,) + x.shape[2:])

        obs_f = flat(traj["obs"])
        alive_f = flat(traj["alive"])

        # Running obs stats update once per epoch on the full batch and take
        # effect NEXT epoch: this epoch's training must normalize with the
        # same stats the rollout used, or old_neglogp and the new mu disagree.
        obs_norm_next = RN.update(ts.obs_norm, obs_f)
        obs_norm = ts.obs_norm

        val_norm = RN.update(ts.val_norm, returns.reshape(-1, 1)) \
            if cfg.normalize_value else ts.val_norm
        returns_f = flat(returns)
        ret_norm_f = RN.normalize_value(val_norm, returns_f[:, None])[:, 0] \
            if cfg.normalize_value else returns_f

        adv_f = flat(advs)
        if cfg.normalize_advantage:
            denom = torch.clamp_min(alive_f.sum(), 1.0)
            mean = (adv_f * alive_f).sum() / denom
            var = (((adv_f - mean) ** 2) * alive_f).sum() / denom
            adv_f = (adv_f - mean) / torch.sqrt(var + 1e-8)

        batch_all = dict(obs=obs_f, action=flat(traj["action"]), old_mu=flat(traj["mu"]),
                         old_neglogp=flat(traj["neglogp"]), adv=adv_f,
                         return_norm=ret_norm_f, alive=alive_f, ctx_dof=flat(traj["ctx_dof"]))

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
                perm = torch.as_tensor(draws["perms"][e], device=dev)
            for i in range(self.num_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in batch_all.items()}
                loss, stats = self._loss(ts.params, batch, obs_norm)
                grads = torch.autograd.grad(loss, plist)
                if self.use_fused:
                    count = fused_clip_adam_apply(plist, opt.mu, opt.nu, grads, opt.count,
                                                  lr, cfg.grad_norm)
                    opt = AdamState(count=count, mu=opt.mu, nu=opt.nu)
                else:
                    opt = clip_adam_apply(plist, opt, grads, lr, cfg.grad_norm)
                lr = self._adapt_lr(lr, stats["kl"].detach())
                stats_rows.append(torch.stack([v.detach() for v in stats.values()]))

        stat_means = torch.stack(stats_rows).mean(0)
        metrics = dict(zip(stats.keys(), stat_means))
        alive_sum = torch.clamp_min(traj["alive"].sum(), 1.0)
        metrics["reward_mean"] = (traj["reward"] * traj["alive"]).sum() / alive_sum
        metrics["alive_ratio"] = traj["alive"].mean()
        metrics["episode_return"] = traj["reward"].sum(0).mean()
        subs = (traj["sub_rewards"] * traj["alive"][..., None]).sum((0, 1)) / alive_sum
        for i, name in enumerate(["dof_reward", "vel_reward", "body_pos_reward",
                                  "body_rot_reward"]):
            metrics[name] = subs[i]
        # success = episode ended by reaching the motion's end rather than a
        # tracking failure
        succ = (traj["done"] * (1.0 - traj["terminate"])).sum()
        metrics["success_rate"] = succ / torch.clamp_min(traj["done"].sum(), 1.0)
        metrics["lr"] = torch.as_tensor(lr, device=dev)

        new_ts = TrainState(params=ts.params, opt_state=opt, obs_norm=obs_norm_next,
                            val_norm=val_norm, generator=ts.generator,
                            epoch=ts.epoch + 1, lr=metrics["lr"])
        return new_ts, metrics
