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

Domain randomization (the env's `rand_specs`): every epoch steps a copy of
the env with a model perturbed from the env's own (never from the last
epoch's), at schedule step `epoch · horizon`; action noise goes on what the
env executes (the stored action and its neglogp stay the policy's), obs noise
on the next raw obs.

Context IK (`use_context_ik`): the params are `{ac, ctx}` (`ImitatorNet` and
`ContextHeads`); the imitation targets come from the analytic IK
(``core/ik.py``) of the (possibly corrupted) context positions with the
heads' twist and leaf residuals. The update re-runs the IK with gradients on
every minibatch and adds the auxiliary dof-rot6d and body-position losses
against the ground-truth context.

The random draws of an epoch (reset times, the context corruption, action
noise, the randomization's draws, minibatch permutations) come from the
train state's generator, or from `draws=` so a test can feed the JAX
learner's draws.

CUDA graphs (`graphed`): JAX runs the epoch as one jitted program. On the
card, a learner with no mesh replays each env step (policy, the context IK,
noise, `env.step`, the trajectory row) and each optimizer step (gather, the
context IK with its gradient, loss, gradient, K1 or the optax chain,
adaptive lr, stats row) from a CUDA graph over static tensors
(``utils/graphs.py``); the reset with its corruption, the draws (in the
eager order), the randomization's per-step perturbations (drawn and
scheduled outside, added inside), GAE, the running norms and the metrics
stay eager. Under model randomization the graphs step one static env whose
randomized fields take each epoch's values in place. `_train_epoch_eager`
is the CPU path and the graphed epoch's oracle.

Data parallelism (`mesh=`, a ``parallel.DataParallelMesh``; the env sharded
with `env.shard(mesh)`): each of the D ranks steps its block of the envs, the
params and Adam state are replicated, and the batch is laid out env-major
as the JAX learner's (dp, local_B). Each mini-epoch draws one permutation
per shard (every rank draws all D and keeps its own); a minibatch is each
shard's `mb_local` rows. The running norms, the advantage normalization and
every metric are global. Two sync modes, as in the JAX learner:
- `dp_sync="per_minibatch"`: the loss is the alive-masked mean over the
  global minibatch (each rank's masked sum over the all-reduced alive
  count); the gradients and the step's stats are summed over the ranks in
  one flat bucket per optimizer step, then the clip and Adam (K1 when
  fused) run on identical gradients on every rank;
- `dp_sync="per_mini_epoch"` (local SGD): each rank steps its own
  minibatches with the optax-chain Adam (never K1, as the JAX learner's
  `mini_epoch_local`), the adaptive lr reads the ranks' mean kl, and the
  params and both moments are averaged in float32 once per mini-epoch.
`minibatch_per_chip=True` makes `minibatch_size` per rank (`mb_local`).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core import ik as IK
from ..core import quat as Q
from ..core import rot as Rt
from ..core import smpl as S
from ..envs.humanoid_im import HumanoidImEnv
from ..ops.fused_adam import fused_clip_adam_apply
from ..parallel import mesh as PM
from ..utils import graphs
from ..utils.runtime import as_draw, resolve_device
from . import running_norm as RN
from .networks import ContextHeads, ImitatorNet
from .optim import AdamState, clip_adam_apply, init_adam


# the loss's stats, in `_loss`'s order (the context IK adds the auxiliary
# losses); the width of one context frame
STAT_NAMES = ("a_loss", "c_loss", "b_loss", "clip_frac", "kl")
AUX_STAT_NAMES = ("aux_dof_loss", "aux_pos_loss")
FRAME_DIM = 378


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
    # data parallelism: `minibatch_size` per rank instead of global, and the
    # gradient sync every optimizer step or (local SGD) once per mini-epoch
    minibatch_per_chip: bool = False
    dp_sync: str = "per_minibatch"         # per_minibatch | per_mini_epoch
    # the context-IK pipeline and its auxiliary losses' weights
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


def _check_mesh(mesh, env, cfg):
    """A learner's (mesh, dp, rank): the mesh must be the port's, and with
    more than one rank the env must be this rank's shard of it."""
    if cfg.dp_sync not in ("per_minibatch", "per_mini_epoch"):
        raise ValueError(f"unknown dp_sync {cfg.dp_sync!r}")
    info = getattr(env, "shard_info", None)
    if mesh is None:
        if info is not None:
            raise ValueError("the env is sharded: pass its mesh")
        return None, 1, 0
    if not isinstance(mesh, PM.DataParallelMesh):
        raise TypeError(f"mesh must be a parallel.DataParallelMesh, not {type(mesh).__name__}")
    if mesh.dp > 1 and (info is None or (info.mesh.dp, info.mesh.rank) != (mesh.dp, mesh.rank)):
        raise ValueError(f"rank {mesh.rank} of {mesh.dp} needs its shard of the env: "
                         "env.shard(mesh)")
    return mesh, mesh.dp, mesh.rank


def _minibatches(nbatch: int, cfg, dp: int):
    """(optimizer steps per mini-epoch, rows each rank gives a minibatch) for
    a global batch of `nbatch` samples over `dp` ranks."""
    mb = cfg.minibatch_size
    if cfg.minibatch_per_chip:
        local = nbatch // dp
        if local % mb:
            raise ValueError(f"local batch {local} not divisible by minibatch {mb}")
        return local // mb, mb
    if mb % dp:
        raise ValueError(f"minibatch {mb} does not split over {dp} ranks")
    if nbatch % mb:
        raise ValueError(f"batch {nbatch} not divisible by minibatch {mb}")
    return nbatch // mb, mb // dp


def _replicate_state(ts, mesh):
    """Every rank's train state set to rank 0's (params, Adam state, running
    norms, lr, epoch)."""
    if mesh is None or not mesh.collective:
        return ts
    for f in ("params", "opt_state", "obs_norm", "val_norm", "lr"):
        setattr(ts, f, PM.replicate(getattr(ts, f), mesh))
    ts.epoch = int(PM.replicate(torch.tensor(ts.epoch, device=ts.lr.device), mesh))
    return ts


def _shard_perm(draws, e: int, n: int, generator, dp: int, rank: int, device):
    """This rank's permutation of its `n` samples in mini-epoch `e`: one
    permutation per shard drawn in shard order (all ranks draw them all), or
    `draws["perms"][e]`, (dp, n) (at dp 1 also (n,))."""
    if draws is None:
        perms = [torch.randperm(n, generator=generator, device=device) for _ in range(dp)]
        return perms[rank]
    perm = as_draw(draws["perms"][e], torch.long, device)
    if perm.dim() == 2:
        return perm[rank]
    if dp != 1:
        raise ValueError(f"under {dp} ranks perms[e] is (dp, local batch), got {tuple(perm.shape)}")
    return perm


class ImitationPPO:
    """Owns the env and the network; the training state flows through
    `init_state` / `train_epoch`."""

    def __init__(self, env: HumanoidImEnv, cfg: PPOConfig = PPOConfig(), seed: int = 7,
                 mesh=None, device=None):
        self.mesh, self.dp, self.rank = _check_mesh(mesh, env, cfg)
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
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
        gen = torch.Generator().manual_seed(seed)
        net = ImitatorNet(num_actions=self.num_actions, obs_dim=self.obs_dim,
                          dtype=self.compute_dtype, generator=gen)
        if cfg.use_context_ik:
            # params named `ac.*` and `ctx.*`; the heads compute in float32
            net = nn.ModuleDict({"ac": net, "ctx": ContextHeads(generator=gen)})
        self.net = net.to(self.device)
        self.use_fused = cfg.fused_optimizer == "on"
        self.sigma = torch.full((self.num_actions,), float(np.exp(cfg.sigma_init)),
                                device=self.device)
        # the env the last epoch stepped (a randomized copy under DR)
        self.last_env = env
        self._smpl_2_mujoco = torch.as_tensor(S.SMPL_2_MUJOCO, dtype=torch.long,
                                              device=self.device)
        self._mujoco_2_smpl = torch.as_tensor(S.MUJOCO_2_SMPL, dtype=torch.long,
                                              device=self.device)

        # the envs of every rank together
        info = getattr(env, "shard_info", None)
        self.num_envs_global = env.cfg.num_envs if info is None else info.num_envs
        self.num_minibatches, self.mb_local = _minibatches(
            self.num_envs_global * cfg.horizon, cfg, self.dp)
        # local SGD only means something across ranks; at dp 1 it is the
        # per-minibatch path (K1 included), as in the JAX learner
        self.local_sgd = cfg.dp_sync == "per_mini_epoch" and self.dp > 1
        self.stat_names = STAT_NAMES + (AUX_STAT_NAMES if cfg.use_context_ik else ())
        # the graphed epoch's static tensors and graphs, made at its first call
        self._st = None
        # the graphed evaluation's, one per record set (`eval.py` `_eval_statics`)
        self._eval_st = {}

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the ranks (itself without collectives)."""
        return PM.all_reduce_sum(t, self.mesh)

    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh train state (the network's initial params unless `params`
        is given); two calls give independent, identical states."""
        names = [k for k, _ in self.net.named_parameters()]
        src = params if params is not None else dict(self.net.named_parameters())
        if sorted(src) != sorted(names):
            raise ValueError(f"params {sorted(set(src) ^ set(names))[:4]} do not match the "
                             "network's")
        params = {k: v.detach().to(self.device, torch.float32).clone().requires_grad_(True)
                  for k, v in src.items()}
        return TrainState(
            params=PM.replicate(params, self.mesh),
            opt_state=init_adam(list(params.values()), self.compute_dtype),
            obs_norm=RN.RunningNormState.create(self.obs_dim, self.device),
            val_norm=RN.RunningNormState.create(1, self.device),
            generator=torch.Generator(self.device).manual_seed(self.seed),
            epoch=0,
            lr=torch.tensor(self.cfg.learning_rate, device=self.device),
        )

    def save_checkpoint(self, path: str, ts: TrainState) -> None:
        """Write params, running stats, Adam state, epoch and lr to one
        `.npz` in the JAX learner's layout (the JAX package's `load_pytree`
        reads it with its own template); bf16 moments are written as f32.
        Under a mesh rank 0 writes the file one process would, and every rank
        returns once it is written."""
        from ..utils import checkpoint as CK

        if self.rank == 0:
            CK.save_npz(path, CK.learner_state_to_jax(ts.params, ts.opt_state, ts.obs_norm,
                                                      ts.val_norm, ts.epoch, ts.lr))
        PM.barrier(self.mesh)

    def load_checkpoint(self, path: str) -> TrainState:
        """Train state from a JAX-package `.npz` checkpoint (params, running
        stats, Adam state, epoch, lr); a context-IK checkpoint's `ac` and
        `ctx` trees included. Under a mesh rank 0 reads the file and every
        rank takes its values."""
        from ..utils import checkpoint as CK

        if self.rank != 0:
            return _replicate_state(self.init_state(), self.mesh)
        flat = CK.load_npz(path)
        ts = self.init_state(CK.params_from_jax(flat))
        ts.opt_state, ts.obs_norm, ts.val_norm, ts.epoch, lr = CK.learner_state_from_jax(
            flat, list(ts.params), self.device, self.compute_dtype)
        if self.cfg.lr_schedule == "adaptive":
            ts.lr = torch.tensor(lr, device=self.device)
        return _replicate_state(ts, self.mesh)

    # -- policy forward -------------------------------------------------------

    def _ctx_frame(self, ctx_feat, t: int):
        """Context frame at rollout step t (index pad + t), split by
        `_split_frame`."""
        return self._split_frame(ctx_feat[:, self.env.cfg.context_padding + t])

    @staticmethod
    def _split_frame(f):
        """One context frame (N, 378), feature layout [obs_pos 72 | rot 96 |
        dof 69 | pos_gt 72 | dof_gt 69], as its five blocks."""
        N = f.shape[0]
        return (f[:, :72].reshape(N, 24, 3), f[:, 72:168].reshape(N, 24, 4), f[:, 168:237],
                f[:, 237:309].reshape(N, 24, 3), f[:, 309:378])

    @staticmethod
    def _sub(params, prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}

    def _apply(self, params, io_n):
        if self.cfg.use_context_ik:
            return functional_call(self.net["ac"], self._sub(params, "ac."), (io_n,))
        return functional_call(self.net, params, (io_n,))

    def _context_targets(self, params, ctx_pos_mj, conf_mj, rest_smpl):
        """The context-IK stage: (possibly corrupted) context positions and
        their confidence -> the heads' twist and leaf residuals -> the
        analytic IK -> imitation targets.

        ctx_pos_mj (B,24,3) MuJoCo-order positions; conf_mj (B,24); rest_smpl
        (B,24,3) the SMPL-order rest pose. Returns (tgt_dof (B,69), tgt_pos
        (B,24,3), tgt_rot quat (B,24,4), local_mj (B,24,3,3))."""
        B = ctx_pos_mj.shape[0]
        pos_smpl = ctx_pos_mj[:, self._mujoco_2_smpl]
        conf_smpl = conf_mj[:, self._mujoco_2_smpl]
        xin = torch.cat([(pos_smpl - pos_smpl[:, :1]).reshape(B, 72), conf_smpl], dim=-1)
        phis, leaf6d = functional_call(self.net["ctx"], self._sub(params, "ctx."), (xin,))
        local, chain, joints = IK.perform_context_ik(pos_smpl, rest_smpl, phis, leaf6d)
        local_mj = local[:, self._smpl_2_mujoco]
        tgt_dof = Rt.rotmat_to_angle_axis(local_mj[:, 1:].reshape(-1, 3, 3)).reshape(B, 69)
        tgt_rot = Q.rotmat_to_quat(chain[:, self._smpl_2_mujoco])
        return tgt_dof, joints[:, self._smpl_2_mujoco], tgt_rot, local_mj

    def _forward(self, params, obs_norm, raw_obs, ctx_feat, t: int, ctx_conf=None):
        """raw env obs + context → (imitation_obs, normalized_obs, mu,
        value_norm, target_dof); mu includes the residual action. With the
        context IK the targets come from the IK of the (corrupted) context
        positions, not the ground-truth channels."""
        pad = self.env.cfg.context_padding
        return self._forward_frame(params, obs_norm, raw_obs, ctx_feat[:, pad + t],
                                   None if ctx_conf is None else ctx_conf[:, pad + t])

    def _forward_frame(self, params, obs_norm, raw_obs, frame, conf=None):
        """`_forward` on one context frame (N, 378) and its confidence."""
        cb_pos, cb_rot, c_dof, _, _ = self._split_frame(frame)
        if self.cfg.use_context_ik:
            if conf is None:
                conf = torch.ones(cb_pos.shape[:-1], device=cb_pos.device)
            c_dof, tgt_pos, tgt_rot, _ = self._context_targets(params, cb_pos, conf,
                                                               self.env.rest_joints_smpl)
            io = self.env.imitation_obs(raw_obs, tgt_pos, tgt_rot, c_dof)
        else:
            io = self.env.imitation_obs(raw_obs, cb_pos, cb_rot, c_dof)
        io_n = RN.normalize(obs_norm, io, self.cfg.obs_clip)
        mu, value = self._apply(params, io_n)
        mu = torch.cat([mu[:, :69] + c_dof, mu[:, 69:]], dim=-1)
        return io, io_n, mu, value, c_dof

    def _value(self, val_norm: RN.RunningNormState, v_norm):
        if not self.cfg.normalize_value:
            return v_norm
        return RN.unnormalize_value(val_norm, v_norm[:, None])[:, 0]

    # -- rollout --------------------------------------------------------------

    @property
    def graphed(self) -> bool:
        """Whether `train_epoch` and `rollout` replay their steps from CUDA
        graphs (``utils/graphs.py``), as the JAX learner runs its epoch as one
        jitted program: on the card, for every config without a mesh
        (amass_im, djokovic_im, federer_im, nadal_im, amass_im_dr,
        amass_im_corrupt). Their steps make no host sync and no draw."""
        return self.device.type == "cuda" and self.mesh is None

    @torch.no_grad()
    def rollout(self, ts: TrainState, draws: Optional[Dict] = None,
                env: Optional[HumanoidImEnv] = None) -> Dict[str, torch.Tensor]:
        """Reset every env, play `horizon` steps; returns the (T, N, ...)
        trajectory with the terminate-masked next values. `env` is the env to
        step (this learner's unless given: an epoch's randomized copy)."""
        if self.graphed and (env is None or env is self.env):
            return {k: v.clone() for k, v in self._rollout_graphed(ts, draws).items()}
        return self._rollout_eager(ts, draws, env)

    @torch.no_grad()
    def _rollout_eager(self, ts: TrainState, draws: Optional[Dict] = None,
                       env: Optional[HumanoidImEnv] = None) -> Dict[str, torch.Tensor]:
        """`rollout` op by op from the host: the oracle of the graphed one,
        and every path's rollout off the graphed path."""
        cfg = self.cfg
        env = self.env if env is None else env
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        dev = self.device
        env_state, raw_obs, ctx = env.reset_all(
            generator=ts.generator,
            motion_times=None if draws is None else draws["motion_times"],
            corrupt_draws=None if draws is None else draws.get("corrupt"))
        ctx_feat = ctx["feat"]
        ctx_conf = ctx["conf"] if cfg.use_context_ik else None
        dr = env.randomizer
        dr_step = ts.epoch * cfg.horizon

        traj = dict(obs=torch.empty(T, N, self.obs_dim, device=dev),
                    action=torch.empty(T, N, A, device=dev),
                    mu=torch.empty(T, N, A, device=dev),
                    ctx_dof=torch.empty(T, N, 69, device=dev),
                    sub_rewards=torch.empty(T, N, 4, device=dev))
        for k in ("neglogp", "value", "reward", "done", "terminate", "alive"):
            traj[k] = torch.empty(T, N, device=dev)
        if cfg.use_context_ik:
            # the update re-runs the context IK with gradients, so the
            # minibatches carry the raw state and the step's context blocks
            traj.update(raw_obs=torch.empty((T,) + raw_obs.shape, device=dev),
                        ctx_pos=torch.empty(T, N, 24, 3, device=dev),
                        ctx_conf=torch.empty(T, N, 24, device=dev),
                        gt_pos=torch.empty(T, N, 24, 3, device=dev),
                        gt_dof=torch.empty(T, N, 69, device=dev))

        shard = env.shard_info
        for t in range(T):
            io, _, mu, v_norm, c_dof = self._forward(ts.params, ts.obs_norm, raw_obs,
                                                     ctx_feat, t, ctx_conf)
            if draws is None:
                noise = PM.draw_rows(shard, mu.shape, lambda sh: torch.randn(
                    sh, generator=ts.generator, device=dev))
            else:
                noise = PM.global_rows(shard, torch.as_tensor(draws["noise"][t], device=dev))
            action = mu + self.sigma[None] * noise
            traj["alive"][t] = (env_state.reset_buf == 0).float()
            if cfg.use_context_ik:
                cb_pos, _, _, gt_pos, gt_dof = self._ctx_frame(ctx_feat, t)
                traj["raw_obs"][t] = raw_obs
                traj["ctx_pos"][t] = cb_pos
                traj["ctx_conf"][t] = ctx_conf[:, env.cfg.context_padding + t]
                traj["gt_pos"][t] = gt_pos
                traj["gt_dof"][t] = gt_dof
            # randomization's action noise goes on what the env executes;
            # the stored action stays the policy's
            env_action = action
            if dr is not None and dr.act_specs:
                env_action = dr.randomize_actions(action, dr_step, ts.generator,
                                                  None if draws is None else draws["dr_act"][t],
                                                  shard)
            env_state, out = env.step(env_state, env_action)
            traj["obs"][t] = io
            traj["action"][t] = action
            traj["mu"][t] = mu
            traj["neglogp"][t] = diag_gaussian_neglogp(action, mu, self.sigma[None])
            traj["value"][t] = self._value(ts.val_norm, v_norm)
            traj["reward"][t] = out.reward
            traj["done"][t] = out.done.float()
            traj["terminate"][t] = out.terminate.float()
            traj["sub_rewards"][t] = out.sub_rewards
            traj["ctx_dof"][t] = c_dof
            raw_obs = out.obs
            if dr is not None and dr.obs_specs:
                raw_obs = dr.randomize_obs(raw_obs, dr_step, ts.generator,
                                           None if draws is None else draws["dr_obs"][t], shard)

        # v(obs_{t+1}) is the value computed at step t+1; one extra forward
        # for the final obs closes the horizon
        _, _, _, vn_last, _ = self._forward(ts.params, ts.obs_norm, raw_obs, ctx_feat, T,
                                            ctx_conf)
        v_next = torch.cat([traj["value"][1:], self._value(ts.val_norm, vn_last)[None]], dim=0)
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

    def _context_obs(self, params, batch):
        """The minibatch's imitation obs, target dofs and auxiliary losses
        from the context IK, with gradients into the context heads: the dof
        rot6d of the IK against the ground truth's, and the IK's body
        positions against the ground truth's (per sample)."""
        tgt_dof, tgt_pos, tgt_rot, local_mj = self._context_targets(
            params, batch["ctx_pos"], batch["ctx_conf"], batch["rest"])
        io = self.env.imitation_obs(batch["raw_obs"], tgt_pos, tgt_rot, tgt_dof)
        B = tgt_dof.shape[0]
        gt_rotmat = Q.quat_to_rotmat(Q.exp_map_to_quat(batch["gt_dof"].reshape(B, 23, 3)))
        gt6 = Rt.rotmat_to_rot6d(gt_rotmat.reshape(-1, 3, 3)).reshape(B, -1)
        ik6 = Rt.rotmat_to_rot6d(local_mj[:, 1:].reshape(-1, 3, 3)).reshape(B, -1)
        aux = {"aux_dof_loss": ((ik6 - gt6) ** 2).mean(-1),
               "aux_pos_loss": ((tgt_pos - batch["gt_pos"]) ** 2).mean((-1, -2))}
        return io, tgt_dof, aux

    def _loss(self, params, batch, obs_norm, denom=None):
        """The PPO loss and its stats as alive-masked means over the batch;
        `denom` (the global minibatch's alive count under a mesh) replaces
        the batch's own count, so the ranks' values sum to the global
        mean."""
        cfg = self.cfg
        if cfg.use_context_ik:
            io, ctx_dof, aux = self._context_obs(params, batch)
        else:
            io, ctx_dof, aux = batch["obs"], batch["ctx_dof"], {}
        io_n = RN.normalize(obs_norm, io, cfg.obs_clip)
        mu_raw, v_norm = self._apply(params, io_n)
        mu = torch.cat([mu_raw[..., :69] + ctx_dof, mu_raw[..., 69:]], dim=-1)
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
        denom = torch.clamp_min(mask.sum() if denom is None else denom, 1.0)

        def masked(x):
            return (x * mask).sum() / denom

        loss = (masked(a_loss) + cfg.critic_coef * masked(c_loss)
                + cfg.bounds_loss_coef * masked(b_loss))
        kl = masked(policy_kl(mu, sigma, batch["old_mu"], sigma))
        stats = dict(a_loss=masked(a_loss), c_loss=masked(c_loss), b_loss=masked(b_loss),
                     clip_frac=masked(clipped), kl=kl)
        if cfg.use_context_ik:
            # the alive-masked auxiliary losses join the PPO objective
            aux_dof, aux_pos = masked(aux["aux_dof_loss"]), masked(aux["aux_pos_loss"])
            loss = loss + cfg.aux_w_dof * aux_dof + cfg.aux_w_pos * aux_pos
            stats.update(aux_dof_loss=aux_dof, aux_pos_loss=aux_pos)
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

    def epoch_env(self, ts: TrainState, draws: Optional[Dict] = None) -> HumanoidImEnv:
        """The env an epoch steps: with model randomization, a copy with a
        model perturbed from this env's own at schedule step epoch·horizon
        (`draws["dr_model"]`: one standard draw per env per model spec);
        otherwise this env."""
        dr = self.env.randomizer
        if dr is None or not dr.model_specs:
            return self.env
        model = dr.randomize_model(self.env.model, ts.epoch * self.cfg.horizon, ts.generator,
                                   None if draws is None else draws["dr_model"],
                                   self.env.shard_info)
        return self.env.with_model(model)

    def train_epoch(self, ts: TrainState, draws: Optional[Dict] = None
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One epoch. `draws` (optional) holds `motion_times` (N,), `noise`
        (T, N, A) and `perms` (mini_epochs, T·N) to use in place of the
        generator's draws; under the context corruption `corrupt` (the
        reset's corruption draws, ``envs/corrupt.py``); under domain
        randomization `dr_model` (per model spec (N,)), `dr_act` (T, per
        action spec (N, A)) and `dr_obs` (T, per obs spec (N, obs_dim)) as
        standard draws. Under a mesh N is every rank's envs (each rank keeps
        its block) and `perms` is (mini_epochs, dp, T·N/dp), one per shard.
        Returns the new state (params and moments are updated in place) and
        the metrics, global under a mesh, as 0-d tensors on the device; the
        env the epoch stepped is kept as `last_env`. On the graphed path
        (`graphed`) every env step and every optimizer step is replayed from
        a CUDA graph."""
        if self.graphed:
            return self._train_epoch_graphed(ts, draws)
        return self._train_epoch_eager(ts, draws)

    def _train_epoch_eager(self, ts: TrainState, draws: Optional[Dict] = None
                           ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """`train_epoch` op by op from the host."""
        env = self.epoch_env(ts, draws)
        self.last_env = env
        traj = self._rollout_eager(ts, draws, env)
        batch_all, obs_norm_next, val_norm, lr = self._prepare(ts, traj)
        stat_means, lr, opt = self._update_eager(ts, batch_all, lr, draws)
        return self._finish(ts, traj, stat_means, lr, opt, obs_norm_next, val_norm)

    def _train_epoch_graphed(self, ts: TrainState, draws: Optional[Dict] = None
                             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """`train_epoch` with each env step and each optimizer step one call
        of a `StaticGraph` (replayed from a CUDA graph on the card; on the CPU
        the same staged steps run as they are). The reset, the draws, GAE,
        the running norms and the metrics stay eager. The draws come from the
        generator in the eager epoch's order (the reset's, T action noises,
        each mini-epoch's permutation), so both epochs take the same. The
        epoch's randomized env (`epoch_env`) is made eager, kept as
        `last_env`, and its constants copied into the static env the
        graphs step."""
        env = self.epoch_env(ts, draws)
        self.last_env = env
        traj = self._rollout_graphed(ts, draws, env)
        batch_all, obs_norm_next, val_norm, lr = self._prepare(ts, traj)
        stat_means, lr, opt = self._update_graphed(ts, batch_all, lr, draws)
        return self._finish(ts, traj, stat_means, lr, opt, obs_norm_next, val_norm)

    def _prepare(self, ts: TrainState, traj):
        """GAE, the running norms and the epoch's samples: (the batch, env-
        major (T·N, ...); the obs norm for the next epoch; this epoch's value
        norm; this epoch's lr)."""
        cfg = self.cfg
        dev = self.device
        advs = self._gae(traj)
        returns = advs + traj["value"]

        T, N = cfg.horizon, self.env.cfg.num_envs
        B = T * N          # this rank's samples (the JAX learner's local_B)

        def flat(x):
            """(T, N, ...) → (N·T, ...), env-major: this rank's row of the
            JAX learner's (dp, local_B) layout."""
            return x.transpose(0, 1).reshape((B,) + x.shape[2:])

        obs_f = flat(traj["obs"])
        alive_f = flat(traj["alive"])

        # Running obs stats update once per epoch on the full batch and take
        # effect NEXT epoch: this epoch's training must normalize with the
        # same stats the rollout used, or old_neglogp and the new mu disagree.
        obs_norm_next = RN.update(ts.obs_norm, obs_f, self.mesh)

        val_norm = RN.update(ts.val_norm, returns.reshape(-1, 1), self.mesh) \
            if cfg.normalize_value else ts.val_norm
        returns_f = flat(returns)
        ret_norm_f = RN.normalize_value(val_norm, returns_f[:, None])[:, 0] \
            if cfg.normalize_value else returns_f

        adv_f = flat(advs)
        if cfg.normalize_advantage:
            # the masked mean and variance of the global batch
            s = self._sum(torch.stack([alive_f.sum(), (adv_f * alive_f).sum()]))
            denom = torch.clamp_min(s[0], 1.0)
            mean = s[1] / denom
            var = self._sum((((adv_f - mean) ** 2) * alive_f).sum()) / denom
            adv_f = (adv_f - mean) / torch.sqrt(var + 1e-8)

        batch_all = dict(obs=obs_f, action=flat(traj["action"]), old_mu=flat(traj["mu"]),
                         old_neglogp=flat(traj["neglogp"]), adv=adv_f,
                         return_norm=ret_norm_f, alive=alive_f, ctx_dof=flat(traj["ctx_dof"]))
        if cfg.use_context_ik:
            # the train forward recomputes the obs from the raw state and context
            del batch_all["obs"]
            for k in ("raw_obs", "ctx_pos", "ctx_conf", "gt_pos", "gt_dof"):
                batch_all[k] = flat(traj[k])
            batch_all["rest"] = self.env.rest_joints_smpl.repeat_interleave(T, dim=0)

        lr = ts.lr
        if cfg.lr_schedule == "linear":
            frac = np.float32(1.0) - np.float32(ts.epoch) / np.float32(cfg.lr_decay_epochs)
            lr = cfg.learning_rate * torch.clamp(torch.tensor(frac, device=dev),
                                                 cfg.lr_min_frac, 1.0)
        return batch_all, obs_norm_next, val_norm, lr

    def _update_eager(self, ts: TrainState, batch_all, lr, draws):
        """The mini-epochs op by op: (the steps' mean stats, the last lr, the
        Adam state)."""
        cfg = self.cfg
        dev = self.device
        B = cfg.horizon * self.env.cfg.num_envs
        alive_f = batch_all["alive"]
        obs_norm = ts.obs_norm
        names = list(ts.params)
        plist = [ts.params[k] for k in names]
        opt = ts.opt_state
        mb, nmb = self.mb_local, self.num_minibatches
        collective = self.mesh is not None and self.mesh.collective
        # per-minibatch sync all-reduces each step's gradient and stats; local
        # SGD steps each rank on its own minibatches with the optax-chain Adam,
        # as the JAX learner's `mini_epoch_local`, and shares only the kl
        sync = collective and not self.local_sgd
        fused = self.use_fused and not self.local_sgd
        stats_rows = []
        for e in range(cfg.mini_epochs):
            perm = _shard_perm(draws, e, B, ts.generator, self.dp, self.rank, dev)
            if sync:
                # each global minibatch's alive count, for all of the
                # mini-epoch's steps in one collective
                counts = self._sum(alive_f[perm[:nmb * mb]].reshape(nmb, mb).sum(1))
            for i in range(nmb):
                idx = perm[i * mb:(i + 1) * mb]
                batch = {k: v[idx] for k, v in batch_all.items()}
                loss, stats = self._loss(ts.params, batch, obs_norm, counts[i] if sync else None)
                grads = torch.autograd.grad(loss, plist)
                svals = torch.stack([v.detach() for v in stats.values()])
                if sync:
                    # the global gradient and stats: one flat bucket per step
                    *grads, svals = PM.flat_all_reduce(list(grads) + [svals], self.mesh)
                if fused:
                    count = fused_clip_adam_apply(plist, opt.mu, opt.nu, grads, opt.count,
                                                  lr, cfg.grad_norm)
                    opt = AdamState(count=count, mu=opt.mu, nu=opt.nu)
                else:
                    opt = clip_adam_apply(plist, opt, grads, lr, cfg.grad_norm)
                kl = svals[list(stats).index("kl")]
                if self.local_sgd and cfg.lr_schedule == "adaptive":
                    kl = self._sum(kl) / self.dp
                lr = self._adapt_lr(lr, kl)
                stats_rows.append(svals)
            if self.local_sgd and collective:
                # the local-SGD sync: params and both moments averaged in f32
                with torch.no_grad():
                    leaves = plist + opt.mu + opt.nu
                    for t, m in zip(leaves, PM.flat_all_reduce(leaves, self.mesh, mean=True)):
                        t.copy_(m)

        stat_means = torch.stack(stats_rows).mean(0)
        if self.local_sgd:
            stat_means = self._sum(stat_means) / self.dp
        return stat_means, lr, opt

    def _finish(self, ts: TrainState, traj, stat_means, lr, opt, obs_norm_next, val_norm):
        """The epoch's metrics and the new train state."""
        cfg = self.cfg
        T = cfg.horizon
        metrics = dict(zip(self.stat_names, stat_means))
        # the rollout's metrics over every rank's envs, in one collective
        alive, reward = traj["alive"], traj["reward"]
        sums = self._sum(torch.cat([
            torch.stack([alive.sum(), (reward * alive).sum(), reward.sum(),
                         (traj["done"] * (1.0 - traj["terminate"])).sum(), traj["done"].sum()]),
            (traj["sub_rewards"] * alive[..., None]).sum((0, 1))]))
        alive_sum = torch.clamp_min(sums[0], 1.0)
        n_all = self.num_envs_global
        metrics["reward_mean"] = sums[1] / alive_sum
        metrics["alive_ratio"] = sums[0] / (T * n_all)
        metrics["episode_return"] = sums[2] / n_all
        for i, name in enumerate(["dof_reward", "vel_reward", "body_pos_reward",
                                  "body_rot_reward"]):
            metrics[name] = sums[5 + i] / alive_sum
        # success = episode ended by reaching the motion's end rather than a
        # tracking failure
        metrics["success_rate"] = sums[3] / torch.clamp_min(sums[4], 1.0)
        metrics["lr"] = torch.as_tensor(lr, device=self.device)

        new_ts = TrainState(params=ts.params, opt_state=opt, obs_norm=obs_norm_next,
                            val_norm=val_norm, generator=ts.generator,
                            epoch=ts.epoch + 1, lr=metrics["lr"])
        return new_ts, metrics

    # -- the graphed epoch ------------------------------------------------------

    def _statics(self, env_state, raw_obs) -> SimpleNamespace:
        """The graphed epoch's static tensors (made at its first call, from
        the first reset's) and its two `StaticGraph`s: `step` (one env step)
        and `update` (one optimizer step). `env` is the env the step graph
        steps: this learner's, or under model randomization a copy whose
        randomized fields are its own (``envs/domain_rand.py``
        `static_env`); `dr_act`, `dr_obs` the step's noise of each action
        and obs spec; with the context IK `conf` the context frame's
        confidence and the trajectory's rows of the update's inputs."""
        if self._st is not None:
            return self._st
        cfg, dev, env = self.cfg, self.device, self.env
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        traj = dict(obs=torch.empty(T, N, self.obs_dim, device=dev),
                    action=torch.empty(T, N, A, device=dev),
                    mu=torch.empty(T, N, A, device=dev),
                    ctx_dof=torch.empty(T, N, 69, device=dev),
                    sub_rewards=torch.empty(T, N, 4, device=dev))
        for k in ("neglogp", "value", "reward", "done", "terminate", "alive"):
            traj[k] = torch.empty(T, N, device=dev)
        if cfg.use_context_ik:
            traj.update(raw_obs=torch.empty((T,) + raw_obs.shape, device=dev),
                        ctx_pos=torch.empty(T, N, 24, 3, device=dev),
                        ctx_conf=torch.empty(T, N, 24, device=dev),
                        gt_pos=torch.empty(T, N, 24, 3, device=dev),
                        gt_dof=torch.empty(T, N, 69, device=dev))
        dr = env.randomizer
        steps = cfg.mini_epochs * self.num_minibatches
        st = SimpleNamespace(
            env=env if dr is None else dr.static_env(env),
            state=PM.tree_map(torch.clone, env_state), obs=raw_obs.clone(),
            obs_norm=RN.RunningNormState.create(self.obs_dim, dev),
            val_norm=RN.RunningNormState.create(1, dev),
            frame=torch.empty(N, FRAME_DIM, device=dev), noise=torch.empty(N, A, device=dev),
            conf=torch.empty(N, 24, device=dev) if cfg.use_context_ik else None,
            traj=traj, row=torch.zeros(1, dtype=torch.long, device=dev),
            batch=None, idx=torch.empty(self.mb_local, dtype=torch.long, device=dev),
            lr=torch.zeros((), device=dev), count=torch.zeros((), dtype=torch.int32, device=dev),
            stats=torch.empty(steps, len(self.stat_names), device=dev),
            params=None, opt=None)
        st.dr_act, st.dr_obs = ([], []) if dr is None else dr.step_noise_statics(
            (N, A), raw_obs.shape, dev)
        st.step = graphs.StaticGraph(self._graphed_step, dev)
        st.update = graphs.StaticGraph(self._graphed_update, dev)
        self._st = st
        return st

    @torch.no_grad()
    def _rollout_graphed(self, ts: TrainState, draws: Optional[Dict] = None,
                         env: Optional[HumanoidImEnv] = None):
        """The rollout with each step one call of the `step` graph; the
        reset (with its corruption), the draws, the randomization's
        scheduled noise and the last value eager. `env` (this learner's
        unless given: an epoch's randomized copy) is reset, and its
        randomized constants are copied into the static env the graph
        steps. Returns the static trajectory, which the next call
        overwrites."""
        cfg, dev = self.cfg, self.device
        env = self.env if env is None else env
        T, N, A = cfg.horizon, env.cfg.num_envs, self.num_actions
        env_state, raw_obs, ctx = env.reset_all(
            generator=ts.generator, motion_times=None if draws is None else draws["motion_times"],
            corrupt_draws=None if draws is None else draws.get("corrupt"))
        st = self._statics(env_state, raw_obs)
        dr = self.env.randomizer
        if st.env is not self.env:
            dr.refresh_env(st.env, env)
        graphs.refresh(PM.tree_leaves((st.state, st.obs, st.obs_norm, st.val_norm)),
                       PM.tree_leaves((env_state, raw_obs, ts.obs_norm, ts.val_norm)))
        st.params = ts.params
        st.row.zero_()
        key = graphs.tensor_key(list(ts.params.values()))
        feat, pad = ctx["feat"], env.cfg.context_padding
        conf = ctx["conf"] if cfg.use_context_ik else None
        dr_step = ts.epoch * cfg.horizon
        for t in range(T):
            st.frame.copy_(feat[:, pad + t])
            if conf is not None:
                st.conf.copy_(conf[:, pad + t])
            # the eager step's draws, in its order: the policy noise, then
            # each action spec's and each obs spec's
            if draws is None:
                torch.randn((N, A), generator=ts.generator, device=dev, out=st.noise)
            else:
                st.noise.copy_(torch.as_tensor(draws["noise"][t]))
            if dr is not None:
                dr.draw_step_noise(st.dr_act, st.dr_obs, dr_step, ts.generator,
                                   *(None if draws is None or k not in draws else draws[k][t]
                                     for k in ("dr_act", "dr_obs")))
            st.step(key)
        traj = dict(st.traj)
        _, _, _, vn_last, _ = self._forward_frame(ts.params, ts.obs_norm, st.obs,
                                                  feat[:, pad + T],
                                                  None if conf is None else conf[:, pad + T])
        v_next = torch.cat([traj["value"][1:], self._value(ts.val_norm, vn_last)[None]], dim=0)
        traj["next_value"] = v_next * (1.0 - traj["terminate"])
        return traj

    def _graphed_step(self) -> None:
        """One env step on the static tensors: the policy (with the context
        IK on the static confidence) on the static obs and context frame,
        the static noise, the randomization's static action noise, the
        static env's `step`, its static obs noise, the trajectory's row
        `row`, the new state copied back."""
        st, cfg = self._st, self.cfg
        dr = self.env.randomizer
        with torch.no_grad():
            io, _, mu, v_norm, c_dof = self._forward_frame(st.params, st.obs_norm, st.obs,
                                                           st.frame, st.conf)
            action = mu + self.sigma[None] * st.noise
            alive = (st.state.reset_buf == 0).float()
            env_action = action if dr is None else dr.apply_noise(action, dr.act_specs,
                                                                  st.dr_act)
            state, out = st.env.step(st.state, env_action)
            row = dict(obs=io, action=action, mu=mu,
                       neglogp=diag_gaussian_neglogp(action, mu, self.sigma[None]),
                       value=self._value(st.val_norm, v_norm), reward=out.reward,
                       done=out.done.float(), terminate=out.terminate.float(),
                       sub_rewards=out.sub_rewards, ctx_dof=c_dof, alive=alive)
            if cfg.use_context_ik:
                cb_pos, _, _, gt_pos, gt_dof = self._split_frame(st.frame)
                row.update(raw_obs=st.obs, ctx_pos=cb_pos, ctx_conf=st.conf, gt_pos=gt_pos,
                           gt_dof=gt_dof)
            for k, v in row.items():
                st.traj[k].index_copy_(0, st.row, v[None])
            st.row.add_(1)
            obs = out.obs if dr is None else dr.apply_noise(out.obs, dr.obs_specs, st.dr_obs)
            graphs.refresh(PM.tree_leaves((st.state, st.obs)), PM.tree_leaves((state, obs)))

    def _update_graphed(self, ts: TrainState, batch_all, lr, draws):
        """The mini-epochs with each optimizer step one call of the `update`
        graph: (the steps' mean stats, the last lr, the Adam state)."""
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
        through `idx`, the loss and its gradient, K1 (or the optax-chain
        Adam) on `count` and `lr`, the adaptive lr, the stats' row `row`."""
        st, cfg = self._st, self.cfg
        plist = list(st.params.values())
        batch = {k: v[st.idx] for k, v in st.batch.items()}
        loss, stats = self._loss(st.params, batch, st.obs_norm)
        grads = torch.autograd.grad(loss, plist)
        with torch.no_grad():
            svals = torch.stack([v.detach() for v in stats.values()])
            mu, nu = st.opt.mu, st.opt.nu
            if self.use_fused:
                count = fused_clip_adam_apply(plist, mu, nu, grads, st.count, st.lr,
                                              cfg.grad_norm)
            else:
                count = clip_adam_apply(plist, AdamState(st.count, mu, nu), grads, st.lr,
                                        cfg.grad_norm).count
            st.count.copy_(count)
            if cfg.lr_schedule == "adaptive":
                st.lr.copy_(self._adapt_lr(st.lr, svals[list(stats).index("kl")]))
            st.stats.index_copy_(0, st.row, svals[None])
            st.row.add_(1)
