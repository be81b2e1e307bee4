"""Hierarchical tennis environment (PyTorch counterpart of
``vid2player3d_tpu/envs/tennis.py``).

One `step(state, action) -> (state, StepOutput)` runs, over all envs at once:
the masked reset of envs that finished last step, the MVAE kinematic frame
(K2 inside the decoder), the FK targets (K3), the frozen low-level policy,
the humanoid physics substeps, the racket and the ball substeps with racket
and body contacts, the outgoing-bounce estimate, the reward and the
reaction/recovery task machine. Resets are masked `where`-updates, never
host branches.

Frame conventions: court z-up, net at y=0, player on y<0. Kinematic (MVAE)
joint rotations are SMPL-order local rotmats; the physics humanoid is the
24-body articulation of the imitation env (MuJoCo joint order).

Lanes: `spec`, `init_conditions` and the frozen low-level policies may be one
player's or one per lane (dual rallies pair two player identities; the lane
of env i is i % lanes). Every handedness-dependent constant (wrist, hands,
grip, welded racket mass, two-hand flag) is a per-env array taken from the
env's lane; the MVAE decodes each lane's rows (a static stride) with that
lane's spec, and the lanes interleave again. The two-hand backhand
(`tennis/twohand.py`) pulls the free hand onto the racket handle on backhand
frames of the lanes that have it. `DualTennisEnv` (``envs/tennis_dual.py``)
overrides the hooks `_init_tar_action`, `_post_reset`, `_reaction_trigger`,
`_reaction_ball` and `_couple_done`.

Randomness: the env owns a `torch.Generator` seeded by `seed`. `reset_all`
and `step` take `draws=` in place of its draws, so a test can feed the JAX
package's draws:
- reset: `init_idx` (N,) init-condition rows (of the env's lane's set),
  `root_xy_u` (N, 2) uniforms, `ball_idx` (N,) pool rows, `target_u` (N,)
  or (N, 3) uniforms, `tt` (N,) ints in [-5, 5); the dual env adds
  `serve_u` (N, 3) uniforms;
- step: `reset` (the reset draws of the masked reset, for K candidates or N
  envs), `rw_noise` (N, latents) normals, `ball_idx`, `near_jitter` (N,),
  `target_u`, `tt`.

Domain randomization (`rand_specs`, ``envs/domain_rand.py``) is applied by
the learner: `with_model` gives a shallow copy stepping a perturbed model and
perturbed ball constants for one epoch (a randomized `BallParams` field is a
0-d tensor on the device, read without a host sync), and noise goes on the
actions and observations every step.

Data parallelism: `shard(mesh)` gives this rank's block of the envs (each
rank's envs per lane count must divide, so lane i % lanes stays inside the
rank). Every draw of a sharded env is made at the global env count and the
block kept, and draws handed in are global, so D ranks step exactly the
envs one process steps. The candidate resets are the global K rows on every
rank; a done env takes the candidate of its place among all ranks' done
envs (one all-gather of the done counts per step).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import quat as Q
from ..core import rot as R
from ..core import smpl as S
from ..ops.fk import fk_chain
from ..parallel import mesh as PM
from ..physics import asset, engine
from ..physics.model import ArticulationModel, ArticulationState, ContactParams
from ..tennis import ball as B
from ..tennis import court
from ..tennis import player as P
from ..tennis import twohand
from ..tennis.racket import grip_arrays
from ..utils.runtime import as_draw, resolve_device
from . import domain_rand
from .obs import compute_imitation_obs


@dataclasses.dataclass(frozen=True)
class TennisConfig:
    num_envs: int = 64
    control_dt: float = 1.0 / 30.0
    substeps: int = 6
    max_episode_length: int = 300
    # action space: 32 MVAE latents x vae_action_scale + 3 residual dof
    num_latents: int = 32
    add_residual_dof: bool = True
    add_residual_root: bool = False
    residual_root_scale: float = 0.02
    vae_action_scale: float = 1.5
    random_walk_in_recovery: bool = True
    fix_head_orientation: bool = False   # look at the ball
    # two-hand backhand: pull the free hand onto the racket handle on
    # backhand frames, a fixed number of IK Adam steps inside the step
    two_hand_backhand: bool = False
    two_hand_iters: int = 8
    # initial ball: "pool" launches from the trajectory pool; "serve_toss"
    # synthesizes the serve toss from the free hand
    init_ball_type: str = "pool"
    # racket-ball contact reacts back on the wrist (two-way coupling)
    ball_reaction_force: bool = False
    # ball deflects off the humanoid's body spheres
    ball_body_contact: bool = False
    # task machine
    reset_reaction_nframes: int = 70
    # phase-synchronized launch (off by default: the reference timing)
    sync_launch: bool = False
    sync_phase_rate: float = float(np.pi) / 68.0
    sync_flight_frames: float = -1.0   # <0 = measure from the pool
    sync_tol_frames: float = 6.0
    sync_max_wait: int = 90
    obs_ball_traj_length: int = 10
    use_random_ball_target: str = "continuous"   # "discrete" | "continuous"
    # incoming-ball bounce box half-width in x (m), read where the ball pool
    # is built: 3.0 is the full serve spread, a stage-1a curriculum narrows it
    ball_bounce_x_half: float = 3.0
    # reward
    reward_type: str = "return_w_estimate"       # reach | return | return_w_estimate
    reward_weights: Tuple[Tuple[str, float], ...] = (("pos", 0.1), ("ball_pos", 0.9))
    reward_scales: Tuple[Tuple[str, float], ...] = (
        ("pos", 5.0), ("phase", 10.0), ("bounce_pos", 1.0), ("bounce_time", 0.5))
    enable_early_termination: bool = True
    # player court box
    court_min: Tuple[float, float] = (-5.0, -16.0)
    court_max: Tuple[float, float] = (5.0, -10.0)
    target_bounce_min: Tuple[float, float, float] = (-3.0, 7.0, 0.0)
    target_bounce_max: Tuple[float, float, float] = (3.0, 11.0, 0.0)
    # racket-ball contact model
    racket_restitution: float = 0.8
    spin_gain: float = 2.5      # rev/s per m/s tangential relative speed
    spin_cap: float = 40.0      # rev/s
    # fold the racket's mass and inertia into the racket-hand wrist body
    simulated_racket_mass: bool = True
    ball_traj_pool_len: int = 100
    # domain randomization; model fields perturb per epoch, "ball_*" fields
    # the BallParams constants, obs/action noise per step. None = off
    rand_specs: Optional[Tuple[domain_rand.RandSpec, ...]] = None
    self_collision: bool = True
    # 0 = a full fresh reset of all N envs every step, masked onto the done
    # ones; K > 0 = only K candidate resets, gathered onto the done envs
    reset_candidates: int = 0

    @property
    def num_actions(self) -> int:
        return self.num_latents + (3 if self.add_residual_dof else 0) \
            + (3 if self.add_residual_root else 0)


@dataclasses.dataclass(frozen=True)
class TennisState:
    mvae: P.MVAEPlayerState
    sim: ArticulationState
    # ball
    ball_pos: torch.Tensor        # (N,3)
    ball_vel: torch.Tensor        # (N,3)
    ball_vspin: torch.Tensor      # (N,)
    ball_traj: torch.Tensor       # (N,T,3) future ball positions (rolls left)
    # racket
    racket_pos: torch.Tensor      # (N,3)
    racket_vel: torch.Tensor      # (N,3)
    racket_normal: torch.Tensor   # (N,3)
    racket_impulse: torch.Tensor  # (N,3) pending ball-contact reaction impulse
    # task machine
    tar_action: torch.Tensor      # (N,) int32: 1 reaction, 0 recovery
    tar_time: torch.Tensor        # (N,) int32
    tar_time_total: torch.Tensor  # (N,) int32
    target_bounce: torch.Tensor   # (N,3)
    has_contact: torch.Tensor     # (N,) bool latched this cycle
    has_bounce: torch.Tensor      # (N,) bool outgoing-ball bounce latch
    bounce_pos: torch.Tensor      # (N,3)
    bounce_in: torch.Tensor       # (N,) bool
    est_bounce_pos: torch.Tensor  # (N,2)
    est_bounce_time: torch.Tensor  # (N,)
    est_bounce_in: torch.Tensor   # (N,) bool
    est_max_height: torch.Tensor  # (N,)
    # bookkeeping
    progress: torch.Tensor        # (N,) int32
    reset_buf: torch.Tensor       # (N,) int32
    terminate_buf: torch.Tensor   # (N,) int32


@dataclasses.dataclass(frozen=True)
class StepOutput:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    terminate: torch.Tensor
    sub_rewards: torch.Tensor
    # behavioral per-step stats for the learner's metrics
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def _zip_envs(fn, *states):
    """fn(field of each state) over every per-env tensor of one or more
    states (nested dataclasses included): every field of TennisState,
    MVAEPlayerState and ArticulationState has the env axis first, so none is
    kept by shape."""
    return type(states[0])(**{
        f.name: (_zip_envs(fn, *xs) if dataclasses.is_dataclass(xs[0]) else fn(*xs))
        for f in dataclasses.fields(states[0])
        for xs in ([getattr(st, f.name) for st in states],)})


def _rows_where(mask, new, old):
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


class TennisEnv:
    """Owns the static pieces (player spec, articulation model, ball pool,
    frozen low-level policy) on one device; `reset_all` and `step` are
    functions of the state."""

    def __init__(self, cfg: TennisConfig, spec, init_conditions,
                 ball_generator: Optional[B.TennisBallGenerator] = None,
                 smpl_model: Optional[S.SMPLModel] = None,
                 betas: Optional[np.ndarray] = None,
                 pi_low: Optional[Callable] = None,
                 pi_low_b: Optional[Callable] = None,
                 two_hand_lanes: Optional[Tuple[bool, ...]] = None,
                 contact_params: ContactParams = ContactParams(),
                 seed: int = 0, device=None):
        """`spec` and `init_conditions` are one player's, or tuples with one
        per lane (init sets of different sizes are trimmed to the smallest).
        `pi_low_b` is the second lane's frozen low-level policy (else lane 1
        uses `pi_low` too); `two_hand_lanes` the per-lane two-hand flags
        (else `cfg.two_hand_backhand` for every lane)."""
        self.randomizer = domain_rand.DomainRandomizer(cfg.rand_specs) \
            if cfg.rand_specs else None
        specs = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
        if cfg.num_envs % len(specs):
            raise ValueError(f"{cfg.num_envs} envs do not split into {len(specs)} lanes")
        self._lane_specs = specs
        self._lane_two_hand = (tuple(bool(t) for t in two_hand_lanes) if two_hand_lanes is not None
                               else (cfg.two_hand_backhand,) * len(specs))
        if len(self._lane_two_hand) != len(specs):
            raise ValueError(f"{len(self._lane_two_hand)} two-hand flags for {len(specs)} lanes")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = specs[0]
        self.smpl = smpl_model if smpl_model is not None else S.make_synthetic_smpl()
        N = cfg.num_envs
        if betas is None:
            betas = np.zeros((N, 10), np.float32)
        self.model = asset.build_humanoid_model(self.smpl, betas, self_collision=cfg.self_collision,
                                                device=self.device)
        # gender + betas body channel of the low-level imitation obs
        self.motion_bodies = torch.cat(
            [torch.zeros((N, 1)), torch.as_tensor(np.asarray(betas, np.float32))],
            dim=-1).to(self.device)
        if isinstance(init_conditions, (tuple, list)):
            if len(init_conditions) != len(specs):
                raise ValueError(f"{len(init_conditions)} init sets for {len(specs)} lanes")
            k = min(np.asarray(c).shape[0] for c in init_conditions)
            init_conditions = np.concatenate([np.asarray(c, np.float32)[:k]
                                              for c in init_conditions], axis=0)
        else:
            k = np.asarray(init_conditions).shape[0]
        self._init_per_lane = k
        self.init_conditions = torch.as_tensor(np.asarray(init_conditions, np.float32),
                                               device=self.device)
        self.gen = ball_generator or B.TennisBallGenerator(
            {"ball_traj_length": cfg.ball_traj_pool_len}, num_candidates=2048,
            device=self.device)
        if self.gen.device != self.device:
            raise ValueError(f"ball pool is on {self.gen.device}, env on {self.device}")
        # phase-synchronized launch: mean frames from launch until the pool
        # trajectory first enters the strike corridor (y < -11.5)
        self._sync_flight = float(cfg.sync_flight_frames)
        if cfg.sync_launch and self._sync_flight < 0.0:
            pool_y = self.gen.traj_pool[..., 1].cpu().numpy()
            crossed = pool_y < -11.5
            has = crossed.any(axis=1)
            first = np.argmax(crossed, axis=1)
            self._sync_flight = float(first[has].mean()) if has.any() \
                else float(cfg.reset_reaction_nframes)
        self.pi_low = pi_low
        self.pi_low_b = pi_low_b
        self.contact_params = contact_params
        self.ball_params = B.BallParams()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._bind_lane_arrays()
        if cfg.simulated_racket_mass:
            self.model = self._weld_racket_mass(self.model)
        self.obs_dim = 3 + 3 + 24 * 3 + 24 * 6 + 3 + 3 * cfg.obs_ball_traj_length + 2
        self.num_actions = cfg.num_actions
        self._rw = dict(cfg.reward_weights)
        self._rs = dict(cfg.reward_scales)
        self._smpl_2_mujoco = torch.as_tensor(S.SMPL_2_MUJOCO, dtype=torch.long,
                                              device=self.device)
        # the step's constants, made once: a tensor built from host data in
        # the step would be a copy that syncs, which a CUDA graph cannot hold
        dev = self.device
        self._root_xy_scale = torch.tensor([2.0, 1.5], device=dev)
        self._root_xy_center = torch.tensor([0.0, -13.0], device=dev)
        self._toss_lift = torch.tensor([0.0, 0.0, 0.1], device=dev)
        self._toss_apex = torch.tensor([-0.87, -12.10, 2.71], device=dev)
        self._target_lo = torch.tensor(cfg.target_bounce_min, device=dev)
        self._target_hi = torch.tensor(cfg.target_bounce_max, device=dev)
        self._gvec = self._gravity(self.ball_params.gravity)
        self._candidates = None
        # data parallelism (`shard`): this env's place in the global batch,
        # and the global candidate-reset env and its model
        self.shard_info: Optional[PM.EnvShard] = None
        self._cand_base = None
        self._cand_model = None

    # the per-step stats `step` returns in `StepOutput.extras`
    EXTRAS = ("cycle_end", "cycle_hit", "contact_now", "contact_est_in", "swing_fh",
              "swing_bh", "in_reaction", "racket_ball_dist")

    @property
    def num_sub_rewards(self) -> int:
        """The width of `StepOutput.sub_rewards`."""
        return 1 if self.cfg.reward_type == "reach" else 4

    # per-env fields besides the model and the body channel
    _ENV_FIELDS = ("righthand", "wrist_id", "hand_id", "free_hand_id", "racket_dir_c",
                   "racket_normal_c", "two_hand_mask")

    def shard(self, mesh: PM.DataParallelMesh) -> "TennisEnv":
        """A copy of this env holding this rank's contiguous block of the
        envs: `cfg.num_envs` becomes the block's size; the model, the body
        channel and the per-env hand and racket fields are its rows. The init
        conditions, the lane specs, the frozen policies and the ball pool
        stay whole, and so do the candidate resets (the global first K
        envs)."""
        if self.shard_info is not None:
            raise ValueError("this env is sharded already")
        info = PM.EnvShard(mesh, self.cfg.num_envs)
        rows = info.rows
        n, lanes = rows.stop - rows.start, len(self._lane_specs)
        if n % lanes:
            raise ValueError(f"{n} envs per rank do not split into {lanes} lanes: env i's lane "
                             f"(i % {lanes}) must stay inside its rank")
        env = copy.copy(self)
        K = self.cfg.reset_candidates
        if 0 < K < self.cfg.num_envs:
            env._cand_base = self._sliced_env(K)
        env.cfg = dataclasses.replace(self.cfg, num_envs=n)
        env.model = PM.tree_map(lambda x: x[rows], self.model)
        env.motion_bodies = self.motion_bodies[rows]
        for f in self._ENV_FIELDS:
            setattr(env, f, getattr(self, f)[rows])
        env.shard_info = info
        env._candidates = None
        return env

    @property
    def num_envs_global(self) -> int:
        """The envs of every rank together (`cfg.num_envs` unsharded)."""
        return self.cfg.num_envs if self.shard_info is None else self.shard_info.num_envs

    def with_model(self, model=None, ball_params=None) -> "TennisEnv":
        """A shallow copy of this env stepping `model` and `ball_params`
        (randomized ones for one epoch) where given; its candidate resets are
        sliced from the new model. This env keeps its own."""
        env = copy.copy(self)
        if model is not None:
            env.model = model
        if ball_params is not None:
            env.ball_params = ball_params
            env._gvec = env._gravity(ball_params.gravity)
        env._candidates = None
        return env

    def _gravity(self, g) -> torch.Tensor:
        """(0, 0, -g) on the env's device."""
        gvec = torch.zeros(3, device=self.device)
        gvec.narrow(0, 2, 1).fill_(-g)
        return gvec

    def with_randomized_model(self, dr, step, generator=None, draws=None) -> "TennisEnv":
        """A shallow copy of this env stepping its model perturbed by the
        randomizer `dr` at schedule `step`: `draws[i]` holds model spec i's
        standard draws for every env (the global ones when sharded), else
        they come from `generator`. A sharded env's candidate resets are the
        global first K envs, so their model takes those envs' draws."""
        shard = self.shard_info
        if self._cand_base is None:
            return self.with_model(dr.randomize_model(self.model, step, generator, draws, shard))
        if draws is None:
            draws = dr.model_draws(shard.num_envs, generator, self.device)
        K = self.cfg.reset_candidates
        env = self.with_model(dr.randomize_model(self.model, step, None, draws, shard))
        env._cand_model = dr.randomize_model(
            self._cand_base.model, step, None,
            [as_draw(x, torch.float32, self.device)[:K] for x in draws])
        return env

    def _bind_lane_arrays(self):
        """Handedness-dependent per-env arrays from each env's lane spec:
        wrist / hand / free-hand body ids, the grip frame (left-handers get
        the mirrored `lefthand_semi_western` grip) and the two-hand flag."""
        dev = self.device
        names = S.MUJOCO_JOINT_NAMES
        lane = np.arange(self.cfg.num_envs) % len(self._lane_specs)
        rh = np.array([bool(s.righthand) for s in self._lane_specs])[lane]

        def ids(right_name, left_name):
            return torch.as_tensor(np.where(rh, names.index(right_name), names.index(left_name)),
                                   dtype=torch.long, device=dev)

        self.righthand = torch.as_tensor(rh, device=dev)
        self.wrist_id = ids("R_Wrist", "L_Wrist")
        self.hand_id = ids("R_Hand", "L_Hand")
        self.free_hand_id = ids("L_Hand", "R_Hand")
        right, left = grip_arrays("eastern"), grip_arrays("lefthand_semi_western")
        # reach and head radius are grip-independent scalars
        self.racket_reach = right[2]
        self.racket_head_radius = right[3]
        self.racket_dir_c = torch.as_tensor(np.where(rh[:, None], right[0], left[0]), device=dev)
        self.racket_normal_c = torch.as_tensor(np.where(rh[:, None], right[1], left[1]),
                                               device=dev)
        self.two_hand_mask = torch.as_tensor(np.asarray(self._lane_two_hand)[lane], device=dev)
        self.any_two_hand = any(self._lane_two_hand)

    # -- lanes: env rows of lane l are the static stride l::lanes ---------------

    def _lane_rows(self, l: int) -> slice:
        L = len(self._lane_specs)
        return slice(None) if L == 1 else slice(l, None, L)

    def _interleave_lanes(self, parts):
        """Inverse of the per-lane stride split: parts[l] holds lane l's rows
        (tensors or state dataclasses); stacking on a new axis 1 and
        flattening restores the env order (lanes alternate)."""
        if len(parts) == 1:
            return parts[0]

        def merge(*xs):
            return torch.stack(xs, dim=1).reshape((-1,) + xs[0].shape[1:])

        return _zip_envs(merge, *parts) if dataclasses.is_dataclass(parts[0]) else merge(*parts)

    def _lane_init_conditions(self, l: int):
        K = self._init_per_lane
        if self.init_conditions.shape[0] == K:
            return self.init_conditions          # one set shared by every lane
        return self.init_conditions[l * K:(l + 1) * K]

    def _mvae_step(self, mvae: P.MVAEPlayerState, latents, residual) -> P.MVAEPlayerState:
        """One kinematic frame, each lane decoded by its own spec."""
        parts = []
        for l, sp in enumerate(self._lane_specs):
            r = self._lane_rows(l)
            parts.append(P.step(sp, _zip_envs(lambda x: x[r], mvae), latents[r],
                                None if residual is None else residual[r]))
        return self._interleave_lanes(parts)

    def _mvae_reset(self, draws, root_xy) -> P.MVAEPlayerState:
        """MVAE init states from each lane's init frames; `init_idx` (N,)
        indexes the set of the env's lane."""
        idx = PM.global_rows(self.shard_info, as_draw(draws["init_idx"], torch.long, self.device)) \
            if draws is not None and "init_idx" in draws else None
        # a lane's rows of a rank's block are a block of that lane's rows
        lane_shard = None if self.shard_info is None else PM.EnvShard(
            self.shard_info.mesh, self.shard_info.num_envs // len(self._lane_specs))
        parts = []
        for l, sp in enumerate(self._lane_specs):
            r = self._lane_rows(l)
            n = root_xy[r].shape[0]
            i = idx[r] if idx is not None else PM.draw_rows(lane_shard, (n,), lambda sh: (
                torch.randint(0, self._init_per_lane, sh, generator=self.generator,
                              device=self.device)))
            parts.append(P.reset(sp, self._lane_init_conditions(l)[i], root_xy=root_xy[r]))
        return self._interleave_lanes(parts)

    def _apply_pi_low(self, low_obs):
        """The frozen low-level policy; with a second one bound, lane 1's rows
        go through it."""
        if self.pi_low_b is None or len(self._lane_specs) == 1:
            return self.pi_low(low_obs)
        return self._interleave_lanes([self.pi_low(low_obs[0::2]),
                                       self.pi_low_b(low_obs[1::2])])

    def _weld_racket_mass(self, model: ArticulationModel) -> ArticulationModel:
        """Fold the racket's mass and inertia into each env's racket-hand
        wrist body, in float64 numpy: handle = 0.35 m cylinder (0.141 kg),
        head = disc r=0.15 (0.450 kg), both along the grip direction."""
        d = self.racket_dir_c.cpu().numpy().astype(np.float64)   # (N,3)
        m_h, m_d = 0.141, 0.450
        c_h = d * 0.175                         # handle center of mass
        c_d = d * float(self.racket_reach)      # head center
        w = self.wrist_id.cpu().numpy()
        N = model.body_mass.shape[0]
        rows = np.arange(N)

        mass = model.body_mass.cpu().numpy().copy()
        com = model.body_com.cpu().numpy().copy()
        inertia = model.body_inertia.cpu().numpy().copy()

        m0 = mass[rows, w]
        new_m = m0 + m_h + m_d
        new_com = (com[rows, w] * m0[:, None] + m_h * c_h + m_d * c_d) / new_m[:, None]

        def about_new_com(I_own, m, c):
            """Parallel-axis shift of a part (own inertia about its center c)
            to the combined center of mass."""
            r = np.broadcast_to(c, (N, 3)) - new_com
            r2 = (r ** 2).sum(-1)
            shift = m * (r2[:, None, None] * np.eye(3) - np.einsum("ni,nj->nij", r, r))
            return I_own + shift

        I_h = np.eye(3) * (m_h * 0.35 ** 2 / 12.0)
        I_d = np.eye(3) * (0.5 * m_d * 0.15 ** 2)
        I_new = (about_new_com(inertia[rows, w].astype(np.float64), m0[:, None, None],
                               com[rows, w])
                 + about_new_com(I_h, m_h, c_h)
                 + about_new_com(I_d, m_d, c_d))
        inertia[rows, w] = I_new.astype(inertia.dtype)
        mass[rows, w] = new_m
        com[rows, w] = new_com

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        return dataclasses.replace(model, body_mass=t(mass), body_com=t(com),
                                   body_inertia=t(inertia))

    @property
    def rest_joint_offsets(self):
        """(N, 24, 3) parent-relative rest offsets, MuJoCo order."""
        return self.model.joint_pos

    @property
    def rest_joints_smpl(self):
        """(N, 24, 3) global rest joint positions, SMPL order: the rest pose
        of the two-hand IK. Computed once per model and kept with it (a copy
        stepping another model, as `with_model` and `shard` make, computes its
        own), so a step replayed from a CUDA graph reads one tensor."""
        model, rest = getattr(self, "_rest_smpl", (None, None))
        if model is not self.model:
            off = self.model.joint_pos
            g = [torch.zeros_like(off[:, 0])]
            for j in range(1, 24):
                g.append(g[int(self.model.parents[j])] + off[:, j])
            rest = torch.stack(g, dim=1)[:, torch.as_tensor(S.MUJOCO_2_SMPL, dtype=torch.long,
                                                            device=off.device)]
            self._rest_smpl = (self.model, rest)
        return rest

    # -- random draws ----------------------------------------------------------

    def _rand(self, draws, name, shape):
        if draws is not None and name in draws:
            return PM.global_rows(self.shard_info, as_draw(draws[name], torch.float32,
                                                           self.device))
        return PM.draw_rows(self.shard_info, shape, lambda sh: torch.rand(
            sh, generator=self.generator, device=self.device))

    def _randint(self, draws, name, low, high, n):
        if draws is not None and name in draws:
            return PM.global_rows(self.shard_info, as_draw(draws[name], torch.long, self.device))
        return PM.draw_rows(self.shard_info, (n,), lambda sh: torch.randint(
            low, high, sh, generator=self.generator, device=self.device))

    def _pool_sample(self, draws, n):
        """`n` incoming balls from the pool: rows `ball_idx` or drawn."""
        idx = None if draws is None else draws.get("ball_idx")
        idx = PM.draw_rows(self.shard_info, (n,), lambda sh: self.gen.pool_idx(
            sh[0], self.generator)) if idx is None \
            else PM.global_rows(self.shard_info, as_draw(idx, torch.long, self.device))
        return self.gen.sample(n, idx=idx)

    def step_draws(self, generator: Optional[torch.Generator] = None) -> Dict:
        """One `step`'s draws from `generator` (the env's own unless given),
        in the order, shapes and dtypes in which `step(draws=None)` draws
        them: the masked reset's (`reset`: `root_xy_u`, `init_idx` lane by
        lane, `ball_idx` unless the serve toss launches the ball, `tt`,
        `target_u`, then the hook `_post_reset`'s; for the K candidates, or
        for every env), `rw_noise` (with the random walk in recovery), the
        hook `_reaction_ball`'s (`ball_idx`, `near_jitter`), `tt` and
        `target_u`. `step` given them draws nothing, so a step replayed from
        a CUDA graph takes them as static inputs and sees the numbers the
        eager step draws. The draws are global (a sharded env's `step` keeps
        its rows)."""
        cfg, dev = self.cfg, self.device
        g = self.generator if generator is None else generator
        n = self.num_envs_global
        K = cfg.reset_candidates
        m = K if 0 < K < n else n

        def rand(*shape):
            return torch.rand(shape, generator=g, device=dev)

        def randint(low, high, k):
            return torch.randint(low, high, (k,), generator=g, device=dev)

        def target(k):
            return rand(k) if cfg.use_random_ball_target == "discrete" else rand(k, 3)

        reset = {"root_xy_u": rand(m, 2), "init_idx": self._init_idx_draws(m, g)}
        if cfg.init_ball_type != "serve_toss":
            reset["ball_idx"] = self.gen.pool_idx(m, g)
        reset["tt"] = randint(-5, 5, m)
        reset["target_u"] = target(m)
        reset.update(self._post_reset_draws(m, g))
        draws = {"reset": reset}
        if cfg.random_walk_in_recovery:
            draws["rw_noise"] = torch.randn((n, cfg.num_latents), generator=g, device=dev)
        draws.update(self._reaction_draws(n, g))
        draws["tt"] = randint(-5, 5, n)
        draws["target_u"] = target(n)
        return draws

    def _init_idx_draws(self, m: int, g: torch.Generator) -> torch.Tensor:
        """The (m,) init rows `_mvae_reset` draws for m envs: lane by lane
        (lane l's rows are l::lanes), each lane's in one call."""
        L = len(self._lane_specs)
        idx = torch.empty(m, dtype=torch.long, device=self.device)
        for l in range(L):
            idx[l::L] = torch.randint(0, self._init_per_lane, (len(range(l, m, L)),),
                                      generator=g, device=self.device)
        return idx

    def _post_reset_draws(self, m: int, g: torch.Generator) -> Dict:
        """The draws of `_post_reset` for m envs (the dual env's serve)."""
        return {}

    def _reaction_draws(self, n: int, g: torch.Generator) -> Dict:
        """The draws of `_reaction_ball` for n envs: the pool sample and the
        near-launch jitter."""
        return {"ball_idx": self.gen.pool_idx(n, g), "near_jitter": self.gen.near_jitter(n, g)}

    # -- kinematic targets -------------------------------------------------------

    _HEAD, _NECK = 15, 12
    _HEAD_CHAIN = (0, 3, 6, 9, 12, 15)

    def _fix_head_orientation(self, mvae: P.MVAEPlayerState, ball_pos):
        """Rotate Neck+Head so the character looks at the ball: the head's +z
        look direction is yawed toward the ball, the correction split evenly
        between neck and head; skipped once the ball is missed."""
        rm = mvae.joint_rotmat
        N = rm.shape[0]
        head_g = rm[:, self._HEAD_CHAIN[0]]
        for j in self._HEAD_CHAIN[1:]:
            head_g = head_g @ rm[:, j]
        lookat = head_g[..., :2, 2]
        lookat = lookat / (torch.linalg.norm(lookat, dim=-1, keepdim=True) + 1e-8)
        _, body_pos, _ = self._kinematic_targets(mvae)
        head_id_mj = S.MUJOCO_JOINT_NAMES.index("Head")
        head_ball = ball_pos[:, :2] - body_pos[:, head_id_mj, :2]
        head_ball = head_ball / (torch.linalg.norm(head_ball, dim=-1, keepdim=True) + 1e-8)
        diff = torch.atan2(head_ball[:, 1], head_ball[:, 0]) \
            - torch.atan2(lookat[:, 1], lookat[:, 0])
        diff = torch.atan2(torch.sin(diff), torch.cos(diff))
        miss = (ball_pos[:, 1] < mvae.root_pos[:, 1] - 0.5) | (torch.abs(ball_pos[:, 0]) > 4.0)
        diff = torch.where(miss, 0.0, diff)

        aa = R.rotmat_to_angle_axis(
            torch.stack([rm[:, self._HEAD], rm[:, self._NECK]], dim=1).reshape(-1, 3, 3)
        ).reshape(N, 2, 3)
        aa = torch.cat([aa[..., :1], aa[..., 1:2] + diff[:, None, None] / 2.0, aa[..., 2:]],
                       dim=-1)
        new_rm = R.angle_axis_to_rotmat(aa.reshape(-1, 3)).reshape(N, 2, 3, 3)
        joint_rotmat = rm.clone()
        joint_rotmat[:, self._HEAD] = new_rm[:, 0]
        joint_rotmat[:, self._NECK] = new_rm[:, 1]
        return dataclasses.replace(mvae, joint_rotmat=joint_rotmat)

    def _apply_two_hand(self, mvae: P.MVAEPlayerState) -> P.MVAEPlayerState:
        """Two-hand backhand on the backhand frames (swing type 2, phase in
        (2, 5)) of the lanes with the flag: one IK per racket hand among
        them, over all rows, masked to that hand's rows."""
        mask = ((mvae.swing_type == 2) & (mvae.phase_pred > 2.0) & (mvae.phase_pred < 5.0)
                & self.two_hand_mask)
        rm = mvae.joint_rotmat
        hands = {bool(sp.righthand) for sp, th in zip(self._lane_specs, self._lane_two_hand) if th}
        rest = self.rest_joints_smpl
        for rh in sorted(hands):
            rm = twohand.optimize_two_hand_backhand(
                rm, rest, righthand=rh, iters=self.cfg.two_hand_iters,
                mask=mask & (self.righthand == rh),
                num_rows=None if self.shard_info is None else self.num_envs_global)
        return dataclasses.replace(mvae, joint_rotmat=rm)

    def _kinematic_targets(self, mvae: P.MVAEPlayerState, res_root=None):
        """MVAE SMPL-order local rotmats -> PD dof targets (69, MuJoCo order)
        + target body pos/rot for the low-level obs, the FK through K3.
        `res_root`: optional (N,3) residual root translation."""
        rot_mj = mvae.joint_rotmat[:, self._smpl_2_mujoco]
        N = rot_mj.shape[0]
        dof_tar = R.rotmat_to_angle_axis(rot_mj[:, 1:].reshape(-1, 3, 3)).reshape(N, 69)
        root_pos = mvae.root_pos if res_root is None else mvae.root_pos + res_root
        body_pos, body_rotmat = fk_chain(rot_mj, self.rest_joint_offsets, root_pos,
                                         self.model.parents)
        return dof_tar, body_pos, Q.rotmat_to_quat(body_rotmat)

    # -- reset helpers -----------------------------------------------------------

    def _serve_toss(self, free_hand_pos):
        """Serve ball toss from the free hand: launch 0.1 m above it with the
        projectile velocity that reaches the toss apex (−0.87, −12.10, 2.71)
        in 25/30 s."""
        t = 25.0 / 30.0
        g = self.ball_params.gravity
        pos = free_hand_pos + self._toss_lift
        d = self._toss_apex[None] - pos
        vel = torch.cat([d[:, :2] / t, ((d[:, 2] + 0.5 * g * t * t) / t)[:, None]], dim=-1)
        vspin = torch.zeros(pos.shape[0], device=self.device)
        res = B.simulate_flight(pos, vel, vspin, num_frames=self.gen.traj_length,
                                p=self.ball_params)
        return res.traj, pos, vel, vspin

    def _sample_target(self, draws, n):
        cfg = self.cfg
        if cfg.use_random_ball_target == "discrete":
            # left / middle / right thirds
            r = self._rand(draws, "target_u", (n,))
            x = torch.where(r < 0.33, -3.0, torch.where(r > 0.67, 3.0, 0.0))
            return torch.stack([x, torch.full_like(x, 10.0), torch.zeros_like(x)], -1)
        lo, hi = self._target_lo, self._target_hi
        return self._rand(draws, "target_u", (n, 3)) * (hi - lo) + lo

    def _init_tar_action(self, N) -> torch.Tensor:
        """Initial task-machine role per env (1 reaction); the dual env starts
        its odd lanes in recovery, awaiting the serve's return."""
        return torch.ones(N, dtype=torch.int32, device=self.device)

    def _post_reset(self, state: TennisState, draws=None) -> TennisState:
        """Post-process a fresh reset state (the dual env synthesizes the
        serve here)."""
        return state

    def _couple_done(self, terminate, done):
        """Rally coupling: the dual env ends both paired envs together."""
        return terminate, done

    def _reaction_trigger(self, state: TennisState, tar_time, contact_now):
        """When a recovery env flips back to reaction: the timed window
        `tar_time == tar_time_total`, or with `cfg.sync_launch` held until
        the swing phase meets the pool's launch-to-strike flight time
        (forced after `sync_max_wait` frames). The dual env: the partner's
        contact."""
        cfg = self.cfg
        if not cfg.sync_launch:
            return tar_time == state.tar_time_total
        delta = torch.remainder(np.pi - state.mvae.phase_pred, 2.0 * np.pi)
        frames_to_contact = delta / cfg.sync_phase_rate
        gate = torch.abs(frames_to_contact - self._sync_flight) <= cfg.sync_tol_frames
        timed = tar_time >= state.tar_time_total
        forced = tar_time >= state.tar_time_total + cfg.sync_max_wait
        return (timed & gate) | forced

    def _reaction_ball(self, state: TennisState, draws, ball_state13, reaction_mask):
        """Incoming ball for envs entering reaction: a pool sample, or, when
        the last rally ball ended on the far side (y > 0), a launch near
        where it landed. Returns (traj, pos, vel, vspin, ok); `ok` marks
        hand-offs that clear the net (always true for pool samples; the dual
        env's mirrored partner ball can be netted)."""
        N = self.cfg.num_envs
        traj, lpos, lvel, lspin = self._pool_sample(draws, N)
        jitter = None if draws is None else draws.get("near_jitter")
        jitter = PM.draw_rows(self.shard_info, (N,), lambda sh: self.gen.near_jitter(
            sh[0], self.generator)) if jitter is None \
            else PM.global_rows(self.shard_info, as_draw(jitter, torch.long, self.device))
        n_traj, n_pos, n_vel, n_spin = self.gen.sample_near(state.ball_pos[:, 0], jitter=jitter)
        other = state.ball_pos[:, 1] > 0.0
        return (_rows_where(other, n_traj, traj), _rows_where(other, n_pos, lpos),
                _rows_where(other, n_vel, lvel), torch.where(other, n_spin, lspin),
                torch.ones(N, dtype=torch.bool, device=self.device))

    def reset_all(self, draws: Optional[Dict] = None) -> Tuple[TennisState, torch.Tensor]:
        """A fresh state for every env: an MVAE init frame with its root near
        the baseline center, the humanoid snapped to the kinematic pose, an
        incoming ball and a bounce target."""
        cfg, dev = self.cfg, self.device
        N = cfg.num_envs
        u_xy = self._rand(draws, "root_xy_u", (N, 2))
        root_xy = (u_xy - 0.5) * self._root_xy_scale + self._root_xy_center
        mvae = self._mvae_reset(draws, root_xy)

        # physics humanoid snapped to the kinematic pose
        dof_tar, body_pos, body_rot = self._kinematic_targets(mvae)
        z3 = torch.zeros((N, 3), device=dev)
        sim = engine.set_state_from_reference(self.model, body_pos[:, 0], body_rot[:, 0], z3, z3,
                                              dof_tar, torch.zeros((N, 69), device=dev))

        if cfg.init_ball_type == "serve_toss":
            bp, _, _, _ = engine.fk_world(self.model, sim)
            traj, lpos, lvel, lspin = self._serve_toss(
                bp[torch.arange(N, device=dev), self.free_hand_id])
        else:
            traj, lpos, lvel, lspin = self._pool_sample(draws, N)
        tt = cfg.reset_reaction_nframes + self._randint(draws, "tt", -5, 5, N)

        racket_pos, racket_normal = self._racket(*self._wrist_state(sim))
        zi = torch.zeros(N, dtype=torch.int32, device=dev)
        zb = torch.zeros(N, dtype=torch.bool, device=dev)
        state = TennisState(
            mvae=mvae, sim=sim,
            ball_pos=lpos, ball_vel=lvel, ball_vspin=lspin, ball_traj=traj,
            racket_pos=racket_pos, racket_vel=z3, racket_normal=racket_normal,
            racket_impulse=z3,
            tar_action=self._init_tar_action(N),
            tar_time=zi, tar_time_total=tt.to(torch.int32),
            target_bounce=self._sample_target(draws, N),
            has_contact=zb, has_bounce=zb, bounce_pos=z3, bounce_in=zb,
            est_bounce_pos=torch.zeros((N, 2), device=dev),
            est_bounce_time=torch.zeros(N, device=dev), est_bounce_in=zb,
            est_max_height=torch.zeros(N, device=dev),
            progress=zi, reset_buf=zi, terminate_buf=zi)
        state = self._post_reset(state, draws)
        return state, self._obs(state)

    def _masked_env_reset(self, state: TennisState, draws=None) -> TennisState:
        """Reset of the envs whose reset_buf latched last step. With
        `reset_candidates=K`, only K fresh states are computed and gathered
        onto the done envs (slot = running count of done envs, clipped);
        otherwise a full fresh reset is masked in."""
        done = state.reset_buf == 1
        K = self.cfg.reset_candidates
        if K <= 0 or K >= self.num_envs_global:
            fresh, _ = self.reset_all(draws)
            return _zip_envs(lambda a, b: _rows_where(done, a, b), fresh, state)
        if self._candidates is None:
            self._candidates = self._sliced_env(K) if self.shard_info is None \
                else self._global_candidates()
        fresh, _ = self._candidates.reset_all(draws)
        slot = torch.cumsum(done, 0) - 1
        if self.shard_info is not None:
            # the lower ranks' done envs come first in the global count
            mesh = self.shard_info.mesh
            counts = PM.all_gather_rows(done.sum().reshape(1), mesh).reshape(-1)
            slot = slot + counts[:mesh.rank].sum()
        slot = torch.clamp(slot, 0, K - 1)
        return _zip_envs(lambda a, b: _rows_where(done, a[slot], b), fresh, state)

    def _global_candidates(self) -> "TennisEnv":
        """A sharded env's candidate-reset env: the global first K envs with
        this env's ball constants and, under model randomization, the
        epoch's model of those envs."""
        env = copy.copy(self._cand_base)
        env.ball_params = self.ball_params
        if self._cand_model is not None:
            env.model = self._cand_model
        return env

    def _sliced_env(self, K: int) -> "TennisEnv":
        """View of this env with num_envs=K (per-env arrays row-sliced) for
        the candidate resets; bodies are the same in every env."""
        env = copy.copy(self)
        env.cfg = dataclasses.replace(self.cfg, num_envs=K)
        env.model = PM.tree_map(lambda x: x[:K], self.model)
        env.motion_bodies = self.motion_bodies[:K]
        for f in self._ENV_FIELDS:
            setattr(env, f, getattr(self, f)[:K])
        env._candidates = None
        return env

    # -- racket -----------------------------------------------------------------

    def _wrist_state(self, sim: ArticulationState, fk=None):
        bp, bq, _, _ = fk if fk is not None else engine.fk_world(self.model, sim)
        rows = torch.arange(bp.shape[0], device=bp.device)
        return bp[rows, self.wrist_id], bq[rows, self.wrist_id]

    def _racket(self, wrist_pos, wrist_quat):
        """Racket head + normal from the player's grip."""
        rm = Q.quat_to_rotmat(wrist_quat)
        rdir = torch.einsum("nab,nb->na", rm, self.racket_dir_c)
        rnormal = torch.einsum("nab,nb->na", rm, self.racket_normal_c)
        return wrist_pos + rdir * self.racket_reach, rnormal

    # -- ball substeps with racket contact --------------------------------------

    def _ball_physics(self, state: TennisState, racket_new_pos, racket_normal,
                      body_centers=None, body_radii=None):
        """Integrate the ball over the control step: aero forces, a swept
        racket-disc contact (closest approach of ball and racket head, both
        linear within the substep), optional inelastic deflection off the
        body spheres, and the ground bounce."""
        cfg = self.cfg
        p = self.ball_params
        dt = cfg.control_dt / cfg.substeps
        N = cfg.num_envs
        r_prev = state.racket_pos
        r_new = racket_new_pos
        racket_vel = (r_new - r_prev) / cfg.control_dt
        gvec = self._gvec

        pos, vel, vspin = state.ball_pos, state.ball_vel, state.ball_vspin
        contact, bounce, bpos = state.has_contact, state.has_bounce, state.bounce_pos
        imp = torch.zeros((N, 3), device=self.device)
        any_hit = torch.zeros(N, dtype=torch.bool, device=self.device)
        reacting = state.tar_action == 1
        for i in range(cfg.substeps):
            f = B.aero_force(vel, vspin, p)
            acc = f / p.mass + gvec
            vel = vel + acc * dt
            pos_new = pos + vel * dt

            alpha0 = i / cfg.substeps
            alpha = (i + 1.0) / cfg.substeps
            r_pos0 = r_prev + alpha0 * (r_new - r_prev)
            r_pos = r_prev + alpha * (r_new - r_prev)
            d0 = pos - r_pos0
            d1 = pos_new - r_pos
            dd = d1 - d0
            denom = torch.sum(dd * dd, dim=-1)
            t_min = torch.clamp(-torch.sum(d0 * dd, dim=-1) / torch.clamp_min(denom, 1e-12),
                                0.0, 1.0)
            d_close = d0 + t_min[:, None] * dd
            dist = torch.linalg.norm(d_close, dim=-1)
            rel_vel = vel - racket_vel
            approaching = torch.sum(rel_vel * d0, dim=-1) < 0
            hit = ((dist < self.racket_head_radius + p.radius + 0.02)
                   & approaching & ~contact & reacting)
            # reflect the relative velocity about the racket normal
            vn = torch.sum(rel_vel * racket_normal, dim=-1, keepdim=True)
            refl = rel_vel - (1.0 + cfg.racket_restitution) * vn * racket_normal
            out_vel = racket_vel + refl
            tangential = refl - torch.sum(refl * racket_normal, dim=-1,
                                          keepdim=True) * racket_normal
            out_spin = torch.clamp(cfg.spin_gain * torch.linalg.norm(tangential, dim=-1),
                                   0.0, cfg.spin_cap)
            # contact impulse on the ball; its negative reacts on the racket
            imp = imp + torch.where(hit[:, None], p.mass * (out_vel - vel), 0.0)
            vel = torch.where(hit[:, None], out_vel, vel)
            vspin = torch.where(hit, out_spin, vspin)
            contact = contact | hit

            if body_centers is not None:
                db = pos_new[:, None] - body_centers            # (N,24,3)
                dist_b = torch.linalg.norm(db, dim=-1)          # (N,24)
                pen = (body_radii + p.radius) - dist_b
                jb = torch.argmax(pen, dim=-1)
                pen_j = torch.gather(pen, 1, jb[:, None])[:, 0]
                nrm = torch.gather(db, 1, jb[:, None, None].expand(N, 1, 3))[:, 0]
                nrm = nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-8)
                vn_b = torch.sum(vel * nrm, dim=-1)
                bhit = (pen_j > 0.0) & (vn_b < 0.0) & ~hit
                vel = torch.where(bhit[:, None], vel - vn_b[:, None] * nrm, vel)
                pos_new = torch.where(bhit[:, None], pos_new + nrm * pen_j[:, None], pos_new)

            # ground bounce
            ground = pos_new[:, 2] <= p.radius
            gvz = vel[:, 2]
            bvel = torch.cat([vel[:, :2] * 0.8, (-p.restitution * gvz)[:, None]], dim=-1)
            vel = torch.where(ground[:, None], bvel, vel)
            pos_new = torch.cat([pos_new[:, :2], torch.clamp_min(pos_new[:, 2:], p.radius)],
                                dim=-1)
            first_bounce = ground & ~bounce & contact   # outgoing-ball bounce
            bpos = torch.where(first_bounce[:, None], pos_new, bpos)
            bounce = bounce | first_bounce
            vspin = torch.where(ground, torch.abs(vspin), vspin)
            any_hit = any_hit | hit
            pos = pos_new
        contact_now = any_hit & ~state.has_contact
        bounce_now = bounce & ~state.has_bounce
        return pos, vel, vspin, contact, bounce, bpos, contact_now, bounce_now, \
            racket_vel, imp

    # -- observations -------------------------------------------------------------

    def _obs(self, state: TennisState, fk=None) -> torch.Tensor:
        """Actor obs 225 (root pos/vel, 23 relative body positions + racket,
        24 rot6d, racket normal) + 10x3 future ball window relative to the
        racket + 2 target."""
        cfg = self.cfg
        N = cfg.num_envs
        bp, bq, bl, _ = fk if fk is not None else engine.fk_world(self.model, state.sim)
        root_pos = bp[:, 0]
        root_vel = bl[:, 0]
        rel = bp[:, 1:] - root_pos[:, None]
        rel = torch.cat([rel.reshape(N, -1), state.racket_pos - root_pos], dim=-1)
        rot6d = R.rotmat_to_rot6d(Q.quat_to_rotmat(bq.reshape(-1, 4))).reshape(N, 24 * 6)
        actor = torch.cat([root_pos, root_vel, rel, rot6d, state.racket_normal], dim=-1)
        ball_win = state.ball_traj[:, :cfg.obs_ball_traj_length]
        task = (ball_win - state.racket_pos[:, None]).reshape(N, -1)
        target = state.target_bounce[:, :2] - root_pos[:, :2]
        obs = torch.cat([actor, task, target], dim=-1)
        return torch.nan_to_num(obs, nan=0.0, posinf=0.0, neginf=0.0)

    # -- rewards --------------------------------------------------------------------

    def _reward(self, state: TennisState, contact_latched, contact_now=None):
        rs, rw = self._rs, self._rw
        phase = state.mvae.phase_pred
        pos_err = torch.sum((state.ball_pos - state.racket_pos) ** 2, dim=-1)

        # contact-quality shaping (weight "quality", default 0): outgoing
        # ball velocity toward the opponent at the contact step
        if contact_now is not None:
            quality = torch.where(contact_now, torch.clamp(state.ball_vel[:, 1] / 12.0, 0.0, 1.0),
                                  0.0)
        else:
            quality = torch.zeros_like(pos_err)
        w_quality = rw.get("quality", 0.0)
        # swing-speed shaping (weight "swing_speed", default 0)
        rspeed = torch.linalg.norm(state.racket_vel, dim=-1)
        swing_speed = torch.where((pos_err < 2.25) & (state.tar_action == 1),
                                  torch.clamp(rspeed / 8.0, 0.0, 1.0), 0.0)
        w_swing = rw.get("swing_speed", 0.0)

        def near_reward(contact_phase):
            phase_err = (phase - contact_phase) ** 2
            return torch.exp(-rs.get("pos", 5.0) * pos_err) * \
                torch.exp(-rs.get("phase", 10.0) * phase_err)

        if self.cfg.reward_type == "reach":
            # unknown swing -> contact phase 3.0
            near = near_reward(torch.where(state.mvae.swing_type == -1, 3.0, np.pi))
            pos_reward = torch.where(state.tar_action == 1, near, 0.0)
            reward = rw.get("pos", 1.0) * pos_reward
            subs = torch.stack([pos_reward], -1)
        elif self.cfg.reward_type == "return":
            # backhand contact tends to be earlier
            near = near_reward(torch.where(state.mvae.swing_type >= 2, 3.0, np.pi))
            pos_reward = torch.where(contact_latched, 1.0, near)
            perr = torch.where(
                state.has_bounce,
                torch.sum((state.bounce_pos - state.target_bounce) ** 2, -1),
                torch.sum((state.ball_pos - state.target_bounce) ** 2, -1))
            ball_pos_reward = torch.where(
                contact_latched, torch.clamp((400.0 - perr) / 400.0, 0.0, 1.0), 0.0)
            reward = rw.get("pos", 0.0) * pos_reward + \
                rw.get("ball_pos", 0.0) * ball_pos_reward + \
                w_quality * quality + w_swing * swing_speed
            subs = torch.stack([pos_reward, ball_pos_reward, quality, swing_speed], -1)
        else:  # return_w_estimate
            near = near_reward(torch.where(state.mvae.swing_type_cycle >= 2, 3.0, np.pi))
            pos_reward = torch.where(contact_latched, 1.0, near)
            perr = torch.sum((state.est_bounce_pos - state.target_bounce[:, :2]) ** 2, -1)
            ball_pos_reward = state.est_bounce_in.to(torch.float32) * \
                torch.exp(-rs.get("bounce_pos", 0.05) * perr) * \
                torch.exp(-rs.get("bounce_time", 0.1) * state.est_bounce_time)
            reward = rw.get("pos", 0.0) * pos_reward + \
                rw.get("ball_pos", 0.0) * ball_pos_reward + \
                w_quality * quality + w_swing * swing_speed
            subs = torch.stack([pos_reward, ball_pos_reward, quality, swing_speed], -1)
        return reward, subs

    # -- step -------------------------------------------------------------------------

    def step(self, state: TennisState, action: torch.Tensor, draws: Optional[Dict] = None
             ) -> Tuple[TennisState, StepOutput]:
        cfg, dev = self.cfg, self.device
        N = cfg.num_envs
        rows = torch.arange(N, device=dev)

        # 1) masked reset of done envs (start of step)
        with torch.autograd.profiler.record_function("masked_reset"):
            state = self._masked_env_reset(state, None if draws is None else draws.get("reset"))

        # 2) action split + recovery random-walk latents
        latents = action[:, :cfg.num_latents] * cfg.vae_action_scale
        if cfg.random_walk_in_recovery:
            if draws is not None and "rw_noise" in draws:
                noise = PM.global_rows(self.shard_info,
                                       as_draw(draws["rw_noise"], torch.float32, dev))
            else:
                noise = PM.draw_rows(self.shard_info, latents.shape, lambda sh: torch.randn(
                    sh, generator=self.generator, device=dev))
            latents = torch.where((state.tar_action == 0)[:, None],
                                  torch.clamp(noise, -5.0, 5.0), latents)
        residual = action[:, cfg.num_latents:cfg.num_latents + 3] \
            if cfg.add_residual_dof else None
        n_res = cfg.num_latents + (3 if cfg.add_residual_dof else 0)
        res_root = action[:, n_res:n_res + 3] * cfg.residual_root_scale \
            if cfg.add_residual_root else None

        # 3) kinematic MVAE frame (+ optional look-at-ball head fix and
        # two-hand backhand)
        mvae = self._mvae_step(state.mvae, latents, residual)
        if cfg.fix_head_orientation:
            mvae = self._fix_head_orientation(mvae, state.ball_pos)
        if self.any_two_hand:
            with torch.autograd.profiler.record_function("two_hand"):
                mvae = self._apply_two_hand(mvae)
        dof_tar, tar_body_pos, tar_body_rot = self._kinematic_targets(mvae, res_root)

        # 4) frozen low-level policy: a residual around the kinematic target,
        # the PD target clamped around the current pose
        fk_prev = engine.fk_world(self.model, state.sim) \
            if self.pi_low is not None or cfg.ball_reaction_force else None
        cur_dof = engine.dof_pos(state.sim)
        lim = 0.5 * np.pi
        root_force = root_torque = None
        if self.pi_low is not None:
            low_obs = self._low_level_obs(state.sim, dof_tar, tar_body_pos, tar_body_rot, fk_prev)
            low_act = self._apply_pi_low(low_obs)
            pd_tar = dof_tar + low_act[:, :69]
            if low_act.shape[-1] >= 75:
                heading_q = Q.calc_heading_quat(Q.remove_base_rot(state.sim.root_quat))
                root_force = Q.quat_rotate(heading_q, low_act[:, 69:72] * 31.85)
                root_torque = Q.quat_rotate(heading_q, low_act[:, 72:75] * 31.85)
        else:
            pd_tar = dof_tar
        pd_tar = torch.clamp(pd_tar, cur_dof - lim, cur_dof + lim)

        # 5) humanoid physics substeps; last step's ball-contact impulse
        # reacts on the wrist (two-way coupling)
        extra_f = extra_t = None
        if cfg.ball_reaction_force:
            react = -state.racket_impulse / cfg.control_dt
            wrist_prev, _ = self._wrist_state(state.sim, fk_prev)
            arm = state.racket_pos - wrist_prev
            extra_f = torch.zeros((N, 24, 3), device=dev)
            extra_t = torch.zeros((N, 24, 3), device=dev)
            extra_f[rows, self.wrist_id] = react
            extra_t[rows, self.wrist_id] = torch.linalg.cross(arm, react, dim=-1)
        sim = engine.control_step(
            self.model, state.sim, pd_tar, root_force, root_torque,
            substeps=cfg.substeps, control_dt=cfg.control_dt,
            contact_params=self.contact_params, extra_force_w=extra_f, extra_torque_w=extra_t)

        # 6) racket from the new wrist pose; ball substeps + contacts
        fk_new = engine.fk_world(self.model, sim)
        bp_new, bq_new = fk_new[0], fk_new[1]
        racket_pos, racket_normal = self._racket(*self._wrist_state(sim, fk_new))
        body_centers = body_radii = None
        if cfg.ball_body_contact:
            # world spheres of the 24 body geoms; the racket-side wrist and
            # hand are left out (the racket disc owns that region)
            off = Q.quat_rotate(bq_new.reshape(-1, 4),
                                self.model.contact_offset[:, :24].reshape(-1, 3)
                                ).reshape(bp_new.shape)
            body_centers = bp_new + off
            body_radii = self.model.contact_radius[:, :24].clone()
            # a scalar assigned through a tensor index is a host copy: scatter
            body_radii.scatter_(1, self.wrist_id[:, None], 0.0)
            body_radii.scatter_(1, self.hand_id[:, None], 0.0)
        (ball_pos, ball_vel, ball_vspin, contact, bounce, bpos, contact_now, bounce_now,
         racket_vel, impulse) = self._ball_physics(state, racket_pos, racket_normal,
                                                   body_centers, body_radii)

        # 7) bounce-in bookkeeping + the outgoing-bounce estimate (every
        # step, masked per env where a contact happened)
        bounce_in = state.bounce_in | (
            bounce_now
            & (bpos[:, 0] > court.COURT_MIN[0]) & (bpos[:, 0] < court.COURT_MAX[0])
            & (bpos[:, 1] > court.COURT_MIN[1]) & (bpos[:, 1] < court.COURT_MAX[1]))
        ball_state13 = B.pack_state(ball_pos, ball_vel, ball_vspin)
        with torch.autograd.profiler.record_function("estimate_out"):
            valid, ebp, ebt, emh = B.estimate_out(ball_state13, num_frames=90,
                                                  p=self.ball_params)
        upd = contact_now & valid
        est_bounce_pos = torch.where(upd[:, None], ebp, state.est_bounce_pos)
        est_bounce_time = torch.where(upd, ebt, state.est_bounce_time)
        est_max_height = torch.where(upd, emh, state.est_max_height)
        est_bounce_in = torch.where(
            upd,
            (ebp[:, 0] > court.COURT_MIN[0]) & (ebp[:, 0] < court.COURT_MAX[0])
            & (ebp[:, 1] > court.COURT_MIN[1]) & (ebp[:, 1] < court.COURT_MAX[1]),
            state.est_bounce_in)

        # 8) roll the future-ball window left, zero at its end
        ball_traj = torch.cat([state.ball_traj[:, 1:], torch.zeros_like(state.ball_traj[:, :1])],
                              dim=1)

        tar_time = state.tar_time + 1
        progress = state.progress + 1

        new_state = dataclasses.replace(
            state, mvae=mvae, sim=sim, ball_pos=ball_pos, ball_vel=ball_vel,
            ball_vspin=ball_vspin, ball_traj=ball_traj,
            racket_pos=racket_pos, racket_vel=racket_vel,
            racket_normal=racket_normal, racket_impulse=impulse,
            has_contact=contact, has_bounce=bounce, bounce_pos=bpos, bounce_in=bounce_in,
            est_bounce_pos=est_bounce_pos, est_bounce_time=est_bounce_time,
            est_bounce_in=est_bounce_in, est_max_height=est_max_height,
            tar_time=tar_time, progress=progress)

        # 9) reward BEFORE the task-machine transitions
        reward, subs = self._reward(new_state, contact, contact_now)
        obs = self._obs(new_state, fk_new)

        # 10) reset / task machine
        root_pos = new_state.sim.root_pos
        cmin, cmax = cfg.court_min, cfg.court_max
        out_of_court = ((root_pos[:, 0] < cmin[0]) | (root_pos[:, 1] < cmin[1])
                        | (root_pos[:, 0] > cmax[0]) | (root_pos[:, 1] > cmax[1]))
        # divergence latch on magnitude as well as NaN: zero the row, the env
        # terminates and resets next step
        has_nan = ~torch.all(torch.isfinite(obs) & (torch.abs(obs) < 1e6), dim=-1)
        obs = torch.where(has_nan[:, None], 0.0, obs)
        # a missed ball that leaves any plausible play volume terminates
        ball_gone = ((torch.abs(ball_pos[:, 0]) > 20.0) | (torch.abs(ball_pos[:, 1]) > 25.0)
                     | (ball_pos[:, 2] > 20.0))
        terminate = out_of_court | has_nan | ball_gone

        in_reaction = new_state.tar_action == 1   # pre-transition role
        ball_passed = (ball_pos[:, 1] < root_pos[:, 1] - 1.0) & in_reaction
        reset_recovery = in_reaction & (contact | ball_passed)
        reset_reaction = self._reaction_trigger(new_state, tar_time, contact_now)

        # incoming ball for reaction transitions; `handoff_ok` ends netted
        # dual hand-offs
        traj_new, lpos, lvel, lspin, handoff_ok = self._reaction_ball(
            new_state, draws, ball_state13, reset_reaction)

        if cfg.enable_early_termination:
            terminate = terminate | (reset_recovery & ~contact) | ball_passed
            if cfg.reward_type.startswith("return_w_estimate"):
                terminate = terminate | (contact & ~est_bounce_in)
        terminate = terminate | (reset_reaction & ~handoff_ok)

        done = terminate | (progress >= cfg.max_episode_length - 1)
        terminate, done = self._couple_done(terminate, done)
        reset_reaction = reset_reaction & ~done
        reset_recovery = reset_recovery & ~done

        # recovery transition: tar_action -> 0, clear the bounce
        tar_action = torch.where(reset_recovery, 0, new_state.tar_action).to(torch.int32)
        has_bounce2 = torch.where(reset_recovery, False, new_state.has_bounce)
        bounce_pos2 = torch.where(reset_recovery[:, None], 0.0, new_state.bounce_pos)

        # reaction transition: new incoming ball + target
        tt_new = (cfg.reset_reaction_nframes + self._randint(draws, "tt", -5, 5, N)
                  ).to(torch.int32)
        tgt_new = self._sample_target(draws, N)
        rr = reset_reaction

        new_state = dataclasses.replace(
            new_state,
            tar_action=torch.where(rr, 1, tar_action).to(torch.int32),
            tar_time=torch.where(rr, 0, tar_time).to(torch.int32),
            tar_time_total=torch.where(rr, tt_new, new_state.tar_time_total),
            target_bounce=_rows_where(rr, tgt_new, new_state.target_bounce),
            ball_pos=_rows_where(rr, lpos, ball_pos), ball_vel=_rows_where(rr, lvel, ball_vel),
            ball_vspin=torch.where(rr, lspin, ball_vspin),
            ball_traj=_rows_where(rr, traj_new, ball_traj),
            has_contact=torch.where(rr, False, contact),
            bounce_in=torch.where(rr, False, bounce_in),
            est_bounce_pos=torch.where(rr[:, None], 0.0, est_bounce_pos),
            est_bounce_time=torch.where(rr, 0.0, est_bounce_time),
            est_bounce_in=torch.where(rr, False, est_bounce_in),
            est_max_height=torch.where(rr, 0.0, est_max_height),
            has_bounce=has_bounce2, bounce_pos=bounce_pos2,
            mvae=dataclasses.replace(
                new_state.mvae,
                swing_type_cycle=torch.where(rr, -1, new_state.mvae.swing_type_cycle
                                             ).to(torch.int32)),
            reset_buf=done.to(torch.int32),
            terminate_buf=terminate.to(torch.int32))

        # behavioral stats per step, aggregated by the learner: swing cycles
        # end on the reaction->recovery transition or on a terminal miss
        # mid-reaction
        f32 = torch.float32
        cycle_end = reset_recovery | (done & in_reaction)
        swing = new_state.mvae.swing_type_cycle
        extras = {
            "cycle_end": cycle_end.to(f32),
            "cycle_hit": (cycle_end & contact).to(f32),
            "contact_now": contact_now.to(f32),
            "contact_est_in": (contact_now & est_bounce_in).to(f32),
            "swing_fh": (cycle_end & (swing == 1)).to(f32),
            "swing_bh": (cycle_end & (swing >= 2)).to(f32),
            "in_reaction": in_reaction.to(f32),
            # court-gated and clamped; the learner reports median / P90 over
            # the valid (non-NaN) frames
            "racket_ball_dist": torch.where(
                in_reaction & ~ball_gone,
                torch.clamp_max(torch.linalg.norm(ball_pos - racket_pos, dim=-1), 30.0),
                float("nan")),
        }
        return new_state, StepOutput(obs=obs, reward=reward, done=done.to(torch.int32),
                                     terminate=terminate.to(torch.int32), sub_rewards=subs,
                                     extras=extras)

    # -- low-level policy obs -------------------------------------------------------

    def _low_level_obs(self, sim, dof_tar, tar_body_pos, tar_body_rot, fk=None):
        """The 734-dim imitation obs of the frozen low-level policy: sim state
        against the kinematic targets, with this player's gender+betas body
        channel."""
        bp, bq, bl, ba = fk if fk is not None else engine.fk_world(self.model, sim)
        return compute_imitation_obs(bp, bq, tar_body_pos, tar_body_rot, engine.dof_pos(sim),
                                     engine.dof_vel(sim), dof_tar, bl, ba, self.motion_bodies)
