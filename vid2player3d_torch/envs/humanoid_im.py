"""Humanoid motion-imitation environment (PyTorch counterpart of
``envs/humanoid_im.py``).

One `step(state, action) -> (state, StepOutput)` does PD control, the
articulation substeps, motion-lib target lookup, reward and termination over
all envs at once. Resets are full-batch (`reset_all`): every env
re-initializes at the start of each rollout segment and finished envs are
alive-masked rather than re-spawned mid-rollout.

Semantics mirror the JAX package: reference-state init with time
truncation, per-step target tracking, exp-of-error imitation reward
(k=60/0.2/100/40, w=0.6/0.1/0.2/0.1), residual root force/torque in the
heading frame, head-height termination + motion-end reset, the
32+2·8-frame motion context, and the divergence (NaN) latch.

Context corruption (`transform_specs`, ``envs/corrupt.py``) degrades the
observed block of the motion context; the ground-truth blocks stay clean for
the context-IK learner's auxiliary losses. Domain randomization
(`rand_specs`, ``envs/domain_rand.py``) is applied by the learner: a
perturbed model per epoch through `with_model`, noise per step.

Data parallelism: `shard(mesh)` gives this rank's block of the envs. Every
draw of a sharded env (reset times, the corruption) is made at the global
env count and the block kept, so D ranks step exactly the envs one process
steps; draws handed in (`motion_times=`, `corrupt_draws=`) are global too.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import quat as Q
from ..core import smpl as S
from ..data import motion_lib as ML
from ..physics import asset, engine
from ..parallel import mesh as PM
from ..physics.model import ArticulationState, ContactParams
from ..utils.runtime import resolve_device
from . import corrupt, domain_rand
from .obs import compute_imitation_obs, dof_to_obs


@dataclasses.dataclass(frozen=True)
class HumanoidImConfig:
    num_envs: int = 64
    control_dt: float = 1.0 / 30.0          # SIM_TIMESTEP 1/60 × controlFrequencyInv 2
    substeps: int = 8                       # physics substeps per control step
    max_episode_length: int = 300
    state_init: str = "Hybrid"             # Default | Start | Random | Hybrid
    hybrid_init_prob: float = 1.0
    context_length: int = 32
    context_padding: int = 8
    truncate_time: bool = True
    residual_force_scale: float = 31.85
    residual_torque_scale: Optional[float] = None
    pd_tar_lim: float = 0.5 * np.pi
    termination_body_height: float = -0.5
    termination_head_height: float = 1.0
    enable_early_termination: bool = True
    ground_tolerance: float = 0.0
    key_bodies: Tuple[str, ...] = ("R_Ankle", "L_Ankle", "L_Hand", "R_Hand")
    contact_bodies: Tuple[str, ...] = ("R_Ankle", "L_Ankle")
    reward_specs: Tuple[Tuple[str, float], ...] = (
        ("k_dof", 60.0), ("k_vel", 0.2), ("k_pos", 100.0), ("k_rot", 40.0),
        ("w_dof", 0.6), ("w_vel", 0.1), ("w_pos", 0.2), ("w_rot", 0.1))
    # context corruption; None = clean context
    transform_specs: Optional[corrupt.TransformSpecs] = None
    # domain randomization; None = off. The learner re-draws the model
    # perturbation every epoch and the obs/action noise every step
    rand_specs: Optional[Tuple[domain_rand.RandSpec, ...]] = None
    # curated sphere-pair self-collision contacts
    self_collision: bool = True

    @property
    def res_torque_scale(self) -> float:
        return self.residual_torque_scale if self.residual_torque_scale is not None \
            else self.residual_force_scale

    @property
    def num_actions(self) -> int:
        return 69 + (6 if self.residual_force_scale > 0 else 0)


@dataclasses.dataclass(frozen=True)
class EnvState:
    sim: ArticulationState
    progress: torch.Tensor       # (N,) int32
    reset_buf: torch.Tensor      # (N,) int32, latched done
    terminate_buf: torch.Tensor  # (N,) int32
    motion_times: torch.Tensor   # (N,) current reference time


@dataclasses.dataclass(frozen=True)
class StepOutput:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    terminate: torch.Tensor
    sub_rewards: torch.Tensor


class HumanoidImEnv:
    """Owns the static config, the articulation model and the motion library
    on one device; `reset_all` and `step` are functions of the state."""

    def __init__(self, cfg: HumanoidImConfig, lib: ML.MotionLib,
                 smpl_model: Optional[S.SMPLModel] = None,
                 motion_ids: Optional[np.ndarray] = None,
                 contact_params: ContactParams = ContactParams(),
                 rng: int = 0, device=None):
        if cfg.transform_specs is not None:
            unknown = set(cfg.transform_specs.mask_joints) - set(S.MUJOCO_JOINT_NAMES)
            if unknown:
                raise ValueError(f"unknown joints to mask: {sorted(unknown)}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lib = lib.to(self.device)
        self.smpl = smpl_model if smpl_model is not None else S.make_synthetic_smpl()
        self.contact_params = contact_params

        # per-env motion assignment, fixed at construction; drawn from a
        # generator seeded by `rng` unless given
        if motion_ids is None:
            gen = torch.Generator().manual_seed(rng)
            motion_ids = ML.sample_motions(self.lib.to("cpu"), cfg.num_envs, gen).numpy()
        motion_ids = np.asarray(motion_ids, dtype=np.int64)
        self.motion_ids = torch.as_tensor(motion_ids, device=self.device)

        # per-env body model from each motion's betas (gender+betas → shape)
        bodies = self.lib.motion_bodies.cpu().numpy()[motion_ids]
        scales = self.lib.motion_body_scales.cpu().numpy()[motion_ids]
        self.motion_bodies = torch.as_tensor(bodies, device=self.device)
        self.model = asset.build_humanoid_model(
            self.smpl, bodies[:, 1:11], scale=scales,
            self_collision=cfg.self_collision, device=self.device)

        names = S.MUJOCO_JOINT_NAMES
        self.head_id = names.index("Head")
        self.key_body_ids = np.array([names.index(n) for n in cfg.key_bodies])
        self.contact_body_ids = torch.as_tensor(
            [names.index(n) for n in cfg.contact_bodies], device=self.device)

        th = np.full(24, cfg.termination_body_height, dtype=np.float32)
        th[self.head_id] = max(cfg.termination_head_height, th[self.head_id])
        self.termination_heights = torch.as_tensor(th, device=self.device)

        # per-env rest joint positions in SMPL order, the rest pose of the
        # learner's context IK: the offsets accumulated over the tree (of the
        # base model: a randomized model keeps this rest pose)
        off = self.model.joint_pos
        rest = [torch.zeros_like(off[:, 0])]
        for j in range(1, 24):
            rest.append(rest[self.model.parents[j]] + off[:, j])
        self.rest_joints_smpl = torch.stack(rest, dim=1)[:, torch.as_tensor(
            S.MUJOCO_2_SMPL, dtype=torch.long, device=self.device)]

        self.randomizer = domain_rand.DomainRandomizer(cfg.rand_specs) \
            if cfg.rand_specs else None

        # identity-quat body-rot block of the sanitized obs of a diverged env
        self._safe_obs = torch.zeros(24 * 3 + 24 * 4 + 69 + 69 + 24 * 3 + 24 * 3
                                     + bodies.shape[-1], device=self.device)
        self._safe_obs[72:168] = torch.tensor([0.0, 0.0, 0.0, 1.0]).repeat(24)
        self.obs_dim = self._safe_obs.shape[0]
        self.num_actions = cfg.num_actions
        # this env's place in a data-parallel batch (`shard`); None: all envs
        self.shard_info: Optional[PM.EnvShard] = None

    def shard(self, mesh: PM.DataParallelMesh) -> "HumanoidImEnv":
        """A copy of this env holding this rank's contiguous block of the
        envs: `cfg.num_envs` becomes the block's size, the per-env arrays
        (motion ids and bodies, the model, the rest joints) its rows. The
        motion library and the termination heights stay whole."""
        if self.shard_info is not None:
            raise ValueError("this env is sharded already")
        info = PM.EnvShard(mesh, self.cfg.num_envs)
        env = copy.copy(self)
        rows = info.rows
        env.cfg = dataclasses.replace(self.cfg, num_envs=rows.stop - rows.start)
        env.model = PM.tree_map(lambda x: x[rows], self.model)
        env.motion_ids = self.motion_ids[rows]
        env.motion_bodies = self.motion_bodies[rows]
        env.rest_joints_smpl = self.rest_joints_smpl[rows]
        env._all_motion_ids = self.motion_ids
        env.shard_info = info
        return env

    def with_model(self, model) -> "HumanoidImEnv":
        """A shallow copy of this env stepping `model` (a randomized one for
        one epoch); this env keeps its own."""
        env = copy.copy(self)
        env.model = model
        return env

    # -- helpers --------------------------------------------------------------

    def _obs_from(self, bp, bq, bl, ba, sim):
        N = bp.shape[0]
        return torch.cat([
            bp.reshape(N, -1), bq.reshape(N, -1), engine.dof_pos(sim),
            engine.dof_vel(sim), bl.reshape(N, -1), ba.reshape(N, -1),
            self.motion_bodies,
        ], dim=-1)

    def _raw_obs(self, sim: ArticulationState) -> torch.Tensor:
        """Raw state concat; the policy computes the 734-dim imitation obs
        from this + the context."""
        return self._obs_from(*engine.fk_world(self.model, sim), sim)

    def split_obs(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        N = obs.shape[0]
        nb = self.motion_bodies.shape[-1]
        names = ["body_pos", "body_rot", "dof_pos", "dof_vel", "body_vel",
                 "body_ang_vel", "motion_bodies"]
        shapes = [(24, 3), (24, 4), (69,), (69,), (24, 3), (24, 3), (nb,)]
        out, o = {}, 0
        for n, sh in zip(names, shapes):
            d = int(np.prod(sh))
            out[n] = obs[:, o:o + d].reshape((N,) + sh)
            o += d
        return out

    def _target(self, motion_times):
        """Reference state at `motion_times + dt` (the 'next frame' target)."""
        return ML.get_motion_state(
            self.lib, self.motion_ids, motion_times + self.cfg.control_dt,
            adjust_height=True, ground_tolerance=self.cfg.ground_tolerance)

    # -- reset ----------------------------------------------------------------

    def reset_all(self, generator: Optional[torch.Generator] = None,
                  motion_times=None, corrupt_draws: Optional[Dict] = None
                  ) -> Tuple[EnvState, torch.Tensor, Dict[str, torch.Tensor]]:
        """Reference-state init for every env. The reset times are drawn from
        `generator` unless `motion_times` (N,) is given, the context
        corruption's draws likewise unless `corrupt_draws` is given (see
        ``envs/corrupt.py``). Returns (state, raw_obs, context) where context
        carries `feat` (N, L+2P, 378), `mask` (N, L+2P) and `conf` (N, L+2P,
        24)."""
        cfg = self.cfg
        N = cfg.num_envs
        if motion_times is not None:
            motion_times = PM.global_rows(self.shard_info, torch.as_tensor(
                motion_times, dtype=torch.float32, device=self.device))
        elif cfg.state_init == "Start":
            motion_times = torch.zeros(N, device=self.device)
        else:
            trunc = cfg.context_length * cfg.control_dt if cfg.truncate_time else None
            phase = PM.draw_rows(self.shard_info, (N,), lambda sh: torch.rand(
                sh, generator=generator, device=self.device))
            motion_times = ML.sample_time(self.lib, self.motion_ids, truncate_time=trunc,
                                          phase=phase)

        ref = ML.get_motion_state(self.lib, self.motion_ids, motion_times,
                                  adjust_height=True, ground_tolerance=cfg.ground_tolerance)
        sim = engine.set_state_from_reference(
            self.model, ref["root_pos"], ref["root_rot"], ref["root_vel"],
            ref["root_ang_vel"], ref["dof_pos"], ref["dof_vel"])

        zeros = torch.zeros(N, dtype=torch.int32, device=self.device)
        state = EnvState(sim=sim, progress=zeros, reset_buf=zeros,
                         terminate_buf=zeros, motion_times=motion_times)
        return state, self._raw_obs(sim), self.init_context(motion_times, generator,
                                                            corrupt_draws)

    def init_context(self, motion_times, generator: Optional[torch.Generator] = None,
                     corrupt_draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Motion-context window: frames at motion_times + dt + dt·[-pad,
        L+pad), features [body_pos, body_rot, dof_pos, body_pos_gt,
        dof_pos_gt]. With `transform_specs` the first block is corrupted and
        `conf` is its confidence; the ground-truth blocks stay clean."""
        cfg = self.cfg
        N = cfg.num_envs
        L = cfg.context_length + 2 * cfg.context_padding
        t0 = motion_times + cfg.control_dt
        steps = cfg.control_dt * torch.arange(-cfg.context_padding,
                                              cfg.context_length + cfg.context_padding,
                                              device=self.device)
        all_times = t0[:, None] + steps[None]                      # (N, L)
        ids = self.motion_ids[:, None].expand(N, L)

        st = ML.get_motion_state(self.lib, ids.reshape(-1), all_times.reshape(-1),
                                 adjust_height=True, ground_tolerance=cfg.ground_tolerance)
        rb_pos = st["rb_pos"].reshape(N, L, -1)
        rb_rot = st["rb_rot"].reshape(N, L, -1)
        dof = st["dof_pos"].reshape(N, L, -1)
        # rb_pos is MuJoCo-ordered: named masks resolve against that list
        obs_pos, conf = corrupt.corrupt_body_pos(
            rb_pos.reshape(N, L, 24, 3), cfg.transform_specs,
            body_names=tuple(S.MUJOCO_JOINT_NAMES), generator=generator, draws=corrupt_draws,
            shard=self.shard_info)
        feat = torch.cat([obs_pos.reshape(N, L, -1), rb_rot, dof, rb_pos, dof], dim=-1)

        lens = self.lib.motion_lengths[self.motion_ids]
        mask = all_times <= (lens + 2 * cfg.control_dt)[:, None]
        return {"feat": feat, "mask": mask, "conf": conf}

    # -- step -----------------------------------------------------------------

    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, StepOutput]:
        cfg = self.cfg
        sim = state.sim

        # zero actions of finished envs
        action = torch.where(state.reset_buf[:, None] == 1, 0.0, action)

        # PD targets: absolute joint targets clamped around the current pose
        cur_dof = engine.dof_pos(sim)
        pd_tar = torch.clamp(action[:, :69], cur_dof - cfg.pd_tar_lim, cur_dof + cfg.pd_tar_lim)

        # residual root force/torque in the heading frame
        root_force = root_torque = None
        if cfg.residual_force_scale > 0:
            res_f = action[:, 69:72] * cfg.residual_force_scale
            res_t = action[:, 72:75] * cfg.res_torque_scale
            heading_q = Q.calc_heading_quat(Q.remove_base_rot(sim.root_quat))
            root_force = Q.quat_rotate(heading_q, res_f)
            root_torque = Q.quat_rotate(heading_q, res_t)

        # reward target = target BEFORE advancing time
        tar_rew = self._target(state.motion_times)

        sim = engine.control_step(
            self.model, sim, pd_tar, root_force, root_torque,
            substeps=cfg.substeps, control_dt=cfg.control_dt,
            contact_params=self.contact_params)

        progress = state.progress + 1
        motion_times = state.motion_times + cfg.control_dt

        bp, bq, bl, ba = engine.fk_world(self.model, sim)
        obs = self._obs_from(bp, bq, bl, ba, sim)
        reward, sub_rewards = self._reward(bp, bq, engine.dof_pos(sim), engine.dof_vel(sim),
                                           tar_rew)
        # zero reward for already-done envs
        was_done = state.reset_buf == 1
        reward = torch.where(was_done, 0.0, reward)
        sub_rewards = torch.where(was_done[:, None], 0.0, sub_rewards)

        # Divergence latch: a diverged simulation terminates the env and its
        # obs are sanitized so that alive-masked losses stay finite (NaN·0 =
        # NaN otherwise). It triggers on magnitude as well as NaN/inf: a
        # blown-up sim can sit at 1e30, whose square overflows f32 in the
        # losses and running stats. The body-rot block sanitizes to identity
        # quaternions, since normalizing a zero quat downstream re-creates
        # the NaN.
        bad = ~torch.all(torch.isfinite(obs) & (torch.abs(obs) < 1e6), dim=-1)
        obs = torch.where(bad[:, None], self._safe_obs[None], obs)
        reward = torch.where(bad, 0.0, reward)
        sub_rewards = torch.where(bad[:, None], 0.0, sub_rewards)

        reset, terminate = self._reset_logic(bp, progress, motion_times)
        one = torch.ones_like(reset)
        reset = torch.where(bad | was_done, one, reset)
        terminate = torch.where(bad, one, terminate)
        terminate = torch.where(was_done, state.terminate_buf, terminate)

        new_state = EnvState(sim, progress, reset, terminate, motion_times)
        return new_state, StepOutput(obs=obs, reward=reward, done=reset,
                                     terminate=terminate, sub_rewards=sub_rewards)

    def _reward(self, body_pos, body_rot, dof_pos_, dof_vel_, tar):
        """Imitation reward: weighted exp-of-error terms for dofs, dof
        velocities, body positions and body rotations."""
        rs = dict(self.cfg.reward_specs)

        dof_reward = torch.exp(-rs["k_dof"] * torch.mean(
            (dof_to_obs(dof_pos_) - dof_to_obs(tar["dof_pos"])) ** 2, dim=-1))
        vel_reward = torch.exp(-rs["k_vel"] * torch.mean(
            (tar["dof_vel"] - dof_vel_) ** 2, dim=-1))
        diff_pos = tar["rb_pos"] - body_pos
        body_pos_reward = torch.exp(-rs["k_pos"] * torch.mean(
            torch.mean(diff_pos ** 2, dim=-1), dim=-1))
        diff_rot = Q.quat_mul(tar["rb_rot"], Q.quat_conjugate(body_rot))
        diff_angle = Q.quat_to_angle_axis(diff_rot)[0]
        body_rot_reward = torch.exp(-rs["k_rot"] * torch.mean(diff_angle ** 2, dim=-1))

        reward = (rs["w_dof"] * dof_reward + rs["w_vel"] * vel_reward
                  + rs["w_pos"] * body_pos_reward + rs["w_rot"] * body_rot_reward)
        subs = torch.stack([dof_reward, vel_reward, body_pos_reward, body_rot_reward], -1)
        return reward, subs

    def _reset_logic(self, body_pos, progress, motion_times):
        cfg = self.cfg
        terminated = torch.zeros_like(progress)
        if cfg.enable_early_termination:
            fall = body_pos[..., 2] < self.termination_heights[None]
            fall = fall.index_fill_(1, self.contact_body_ids, False)
            fall = torch.any(fall, dim=-1) & (progress > 1)
            terminated = fall.to(progress.dtype)
        lens = self.lib.motion_lengths[self.motion_ids]
        reach = (progress >= cfg.max_episode_length - 1) | (motion_times >= lens)
        reset = torch.where(reach, torch.ones_like(terminated), terminated)
        return reset, terminated

    # -- network-side obs (shared with the learner) ---------------------------

    def imitation_obs(self, raw_obs, ctx_body_pos, ctx_body_rot, ctx_dof_pos):
        """734-dim obs from raw env obs + current context frame."""
        d = self.split_obs(raw_obs)
        return compute_imitation_obs(
            d["body_pos"], d["body_rot"], ctx_body_pos, ctx_body_rot,
            d["dof_pos"], d["dof_vel"], ctx_dof_pos, d["body_vel"],
            d["body_ang_vel"], d["motion_bodies"])
