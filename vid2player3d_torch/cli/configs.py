"""Named run configurations (counterpart of ``vid2player3d_tpu/cli/configs.py``).

The one table of named configs in the port: every entry of the JAX
package's `CONFIGS`, with the same values, on the port's `HumanoidImConfig`,
`PPOConfig`, `TennisConfig`, `V2PConfig`, `RandSpec` and `TransformSpecs`.
Each entry cites the reference config it reproduces. CLI overrides
(`--num_envs`, `--seed`, ...) are applied by `cli.run` with
`dataclasses.replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..envs.humanoid_im import HumanoidImConfig
from ..envs.tennis import TennisConfig
from ..learn.ppo import PPOConfig
from ..learn.v2p_ppo import V2PConfig


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    kind: str                      # "im" | "tennis" | "mvae"
    description: str = ""
    env_im: Optional[HumanoidImConfig] = None
    ppo: Optional[PPOConfig] = None
    env_tennis: Optional[TennisConfig] = None
    v2p: Optional[V2PConfig] = None
    mvae_version: Optional[str] = None
    # warm start from a previous curriculum stage (with dim surgery)
    warm_start: Optional[str] = None       # config name whose checkpoint to load
    discard_pretrained_sigma: bool = False
    max_epochs: int = 100000
    seed: int = 0
    player: str = "federer"
    dual: bool = False
    player_b: Optional[str] = None     # dual: far-lane player identity


def _im(name, desc, env, ppo, **kw) -> RunConfig:
    return RunConfig(name=name, kind="im", description=desc, env_im=env,
                     ppo=ppo, **kw)


def _tennis(name, desc, env, v2p, **kw) -> RunConfig:
    return RunConfig(name=name, kind="tennis", description=desc,
                     env_tennis=env, v2p=v2p, **kw)


CONFIGS = {}


def _register(cfg: RunConfig) -> RunConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# ---- low-level imitation (embodied_pose/cfg/*.yaml) --------------------------

_register(_im(
    "amass_im",
    "Stage-1 low-level imitation on AMASS (embodied_pose/cfg/amass_im.yaml)",
    HumanoidImConfig(num_envs=8192, substeps=2, state_init="Hybrid",
                     hybrid_init_prob=1.0, context_length=32,
                     context_padding=8, residual_force_scale=31.85,
                     termination_head_height=1.0),
    PPOConfig(horizon=32, mini_epochs=6, minibatch_size=512,
              learning_rate=2e-5, gamma=0.99, tau=0.95, e_clip=0.2,
              critic_coef=5.0, grad_norm=50.0, sigma_init=-1.756,
              normalize_value=True),
))

_register(_im(
    "djokovic_im",
    "Stage-2 fine-tune on player tennis motion; head termination disabled, "
    "warm start from amass_im (embodied_pose/cfg/djokovic_im.yaml:114)",
    HumanoidImConfig(num_envs=8192, substeps=2, state_init="Hybrid",
                     hybrid_init_prob=1.0,
                     termination_head_height=-0.5),   # disabled (`djokovic_im.yaml`)
    PPOConfig(horizon=32, mini_epochs=6, minibatch_size=512,
              learning_rate=1e-5, sigma_init=-1.756, critic_coef=5.0,
              grad_norm=50.0),
    warm_start="amass_im", player="djokovic",
))

for _p in ("federer", "nadal"):
    _register(dataclasses.replace(CONFIGS["djokovic_im"], name=f"{_p}_im",
                                  player=_p))

# domain-randomized training (`base_task.py:250-445` randomization_params):
# per-epoch model perturbation + per-step obs/action noise with a linear
# ramp-in schedule
from ..envs.domain_rand import RandSpec as _RS  # noqa: E402

_register(_im(
    "amass_im_dr",
    "amass_im with domain randomization: mass/gain scaling + obs/action "
    "noise on a linear schedule",
    dataclasses.replace(
        CONFIGS["amass_im"].env_im,
        rand_specs=(
            _RS(field="body_mass", distribution="uniform", rng=(0.9, 1.1),
                operation="scaling"),
            _RS(field="kp", distribution="uniform", rng=(0.85, 1.15),
                operation="scaling"),
            _RS(field="observations", distribution="gaussian",
                rng=(0.0, 0.002), operation="additive",
                schedule="linear", schedule_steps=3000),
            _RS(field="actions", distribution="gaussian", rng=(0.0, 0.01),
                operation="additive", schedule="linear",
                schedule_steps=3000),
        )),
    CONFIGS["amass_im"].ppo,
))

# corrupted-context training: video-like context degradation + network-side
# IK with aux supervised losses (`humanoid_smpl_im.py:565-592` transform
# specs; `im_network_builder.py:78-138` context pipeline)
from ..envs.corrupt import TransformSpecs as _TS  # noqa: E402

_register(_im(
    "amass_im_corrupt",
    "amass_im with corrupted context (noisy+dropped joints) trained through "
    "the network-side IK pipeline with aux supervised losses",
    dataclasses.replace(
        CONFIGS["amass_im"].env_im,
        transform_specs=_TS(noisy_joints_prob=0.5,
                            noisy_joints_noise_std=0.02,
                            noisy_joints_conf_std=0.02,
                            noisy_joints_min_conf=0.1,
                            mask_random_joints_prob=0.05)),
    dataclasses.replace(CONFIGS["amass_im"].ppo, use_context_ik=True),
))


# ---- high-level curriculum (vid2player/cfg/controller/*.yaml) ----------------

_STAGE1_ENV = TennisConfig(
    num_envs=10240, substeps=2, max_episode_length=600,
    reward_type="reach", use_random_ball_target="discrete",
    reset_reaction_nframes=70,
    # amortized in-step resets: 256 candidate states scattered onto done envs
    reset_candidates=256)

_register(_tennis(
    "federer_train_stage_1",
    "High-level stage 1: reach reward, discrete targets "
    "(federer_train_stage_1.yaml)",
    _STAGE1_ENV,
    V2PConfig(horizon=64, minibatch_size=16384, mini_epochs=6,
              learning_rate=1e-4, sigma_init=-0.69, bounds_loss_coef=10.0,
              critic_coef=5.0, grad_norm=50.0),
))

_register(_tennis(
    "federer_train_stage_2",
    "High-level stage 2: return_w_estimate reward, 6 substeps, warm start "
    "stage 1 (federer_train_stage_2.yaml)",
    dataclasses.replace(_STAGE1_ENV, num_envs=15360, substeps=6,
                        max_episode_length=300,
                        reward_type="return_w_estimate",
                        reward_weights=(("pos", 0.1), ("ball_pos", 0.9)),
                        # full-fidelity physics stages: two-way racket-ball
                        # coupling + ball-vs-body contacts (PhysX always has
                        # both, `humanoid_smpl_im_mvae.py:367-442,388-417`)
                        ball_reaction_force=True,
                        ball_body_contact=True),
    V2PConfig(horizon=32, minibatch_size=16384, mini_epochs=6,
              learning_rate=2e-5, sigma_init=-0.69, bounds_loss_coef=10.0),
    warm_start="federer_train_stage_1", discard_pretrained_sigma=True,
))

_register(_tennis(
    "federer_train_stage_3",
    "High-level stage 3: continuous bounce targets + bounce pos/time reward "
    "(federer_train_stage_3.yaml)",
    dataclasses.replace(
        CONFIGS["federer_train_stage_2"].env_tennis,
        use_random_ball_target="continuous",
        reward_scales=(("pos", 5.0), ("phase", 10.0), ("bounce_pos", 1.0),
                       ("bounce_time", 0.5))),
    dataclasses.replace(CONFIGS["federer_train_stage_2"].v2p,
                        learning_rate=1e-5, sigma_init=-2.9),
    warm_start="federer_train_stage_2", discard_pretrained_sigma=True,
))

for _p in ("federer", "djokovic", "nadal"):
    # inference/demo configs = stage-3 semantics at 30720 envs (`federer.yaml`);
    # the two-handed-backhand players get the two-hand fix
    # (`djokovic.yaml:52` / `nadal.yaml:53` fix_two_hand_backhand_post)
    _register(_tennis(
        _p,
        f"Inference/demo config for {_p} ({_p}.yaml)",
        dataclasses.replace(CONFIGS["federer_train_stage_3"].env_tennis,
                            num_envs=30720,
                            two_hand_backhand=(_p in ("djokovic", "nadal"))),
        CONFIGS["federer_train_stage_3"].v2p,
        warm_start="federer_train_stage_3", player=_p,
    ))
    if _p != "federer":
        for _s in (1, 2, 3):
            base = CONFIGS[f"federer_train_stage_{_s}"]
            _register(dataclasses.replace(base, name=f"{_p}_train_stage_{_s}",
                                          player=_p))

# domain-randomized high-level training (`base_task.py:250-445` applies to
# every reference task): obs/action noise + ball-constant perturbation
_register(_tennis(
    "federer_train_stage_1_dr",
    "Stage 1 with domain randomization: ball COR/drag perturbation + "
    "obs/action noise on a linear schedule",
    dataclasses.replace(
        _STAGE1_ENV,
        rand_specs=(
            _RS(field="ball_restitution", distribution="uniform",
                rng=(0.95, 1.05), operation="scaling"),
            _RS(field="ball_base_cd", distribution="uniform",
                rng=(0.9, 1.1), operation="scaling"),
            _RS(field="observations", distribution="gaussian",
                rng=(0.0, 0.002), operation="additive",
                schedule="linear", schedule_steps=3000),
            _RS(field="actions", distribution="gaussian", rng=(0.0, 0.01),
                operation="additive", schedule="linear",
                schedule_steps=3000),
        )),
    CONFIGS["federer_train_stage_1"].v2p,
))

# stage-1 warm-up leg: identical task, wider reach-reward basin (pos scale
# 0.5 instead of 5.0, phase 1.0 instead of 10.0): the wide basin first pulls
# the racket into range, then `federer_train_stage_1` (warm-started from
# this) tightens to the reference's exact objective
_register(_tennis(
    "federer_train_stage_1a",
    "Stage-1 warm-up: reach reward with a wide distance basin "
    "(single-chip curriculum aid; anneal back via federer_train_stage_1)",
    dataclasses.replace(_STAGE1_ENV,
                        reward_scales=(("pos", 0.5), ("phase", 1.0),
                                       ("bounce_pos", 1.0),
                                       ("bounce_time", 0.5)),
                        # strike-first curriculum: incoming balls land
                        # within +-1 m of the player's start x, so swing
                        # timing is learned before court coverage (stage 1
                        # proper restores the full +-3 m spread)
                        ball_bounce_x_half=1.0),
    CONFIGS["federer_train_stage_1"].v2p,
))

# stage-2 narrow-ball leg: return_w_estimate with the strike-first ball
# distribution (+-1 m bounce x), the bridge between "can strike" (stage 1a)
# and the full-spread stage 2; warm start stage 1
_register(_tennis(
    "federer_train_stage_2a",
    "Stage-2 warm-up: return_w_estimate reward on the narrow strike-first "
    "ball distribution (single-chip curriculum aid)",
    dataclasses.replace(CONFIGS["federer_train_stage_2"].env_tennis,
                        ball_bounce_x_half=1.0,
                        # contact-quality shaping: gradient from graze to
                        # forward strike (see envs/tennis.py::_reward);
                        # stage 2 proper drops it back to the reference's
                        # exact pos/ball_pos weights
                        reward_weights=(("pos", 0.1), ("ball_pos", 0.6),
                                        ("quality", 0.3))),
    CONFIGS["federer_train_stage_2"].v2p,
    warm_start="federer_train_stage_1", discard_pretrained_sigma=True,
))

# stage-2c: stage-2a with the wide near-reward basins (pos 0.5, phase 1.0,
# the stage-1a scales): the sharp default basins give little pre-contact
# shaping for swing timing
_register(_tennis(
    "federer_train_stage_2c",
    "Stage-2 narrow + wide reach basins + quality shaping "
    "(single-chip curriculum aid)",
    dataclasses.replace(CONFIGS["federer_train_stage_2a"].env_tennis,
                        reward_scales=(("pos", 0.5), ("phase", 1.0),
                                       ("bounce_pos", 1.0),
                                       ("bounce_time", 0.5))),
    CONFIGS["federer_train_stage_2"].v2p,
    warm_start="federer_train_stage_1", discard_pretrained_sigma=True,
))

# stage-1/2 sync legs: phase-synchronized ball launch (envs/tennis.py::
# TennisConfig.sync_launch) — the env holds each launch until the swing
# phase, extrapolated over the pool's measured flight, meets the ball at
# contact phase pi, so the fast swing window meets the ball's arrival;
# anneal out by warm-starting the un-synced stage afterwards
_register(_tennis(
    "federer_train_stage_1sync",
    "Stage-1a + phase-synchronized launches (single-chip curriculum aid; "
    "anneal via federer_train_stage_1)",
    dataclasses.replace(CONFIGS["federer_train_stage_1a"].env_tennis,
                        sync_launch=True),
    CONFIGS["federer_train_stage_1"].v2p,
))
_register(_tennis(
    "federer_train_stage_2sync",
    "Stage-2a + phase-synchronized launches (single-chip curriculum aid; "
    "anneal via federer_train_stage_2)",
    dataclasses.replace(CONFIGS["federer_train_stage_2a"].env_tennis,
                        sync_launch=True),
    CONFIGS["federer_train_stage_2"].v2p,
    warm_start="federer_train_stage_1sync", discard_pretrained_sigma=True,
))

# stage-2b: adds dense swing-speed shaping (racket head speed while the
# ball is within reach) on top of stage-2a; the JAX package documents it as
# an experiment whose policy farms the speed term, not a recommended stage
_register(_tennis(
    "federer_train_stage_2b",
    "Stage-2 narrow + swing-speed shaping: racket head speed near the "
    "ball (single-chip curriculum aid)",
    dataclasses.replace(CONFIGS["federer_train_stage_2a"].env_tennis,
                        reward_weights=(("pos", 0.1), ("ball_pos", 0.5),
                                        ("quality", 0.2),
                                        ("swing_speed", 0.2))),
    CONFIGS["federer_train_stage_2"].v2p,
    warm_start="federer_train_stage_1", discard_pretrained_sigma=True,
))

# serve practice: the serve-toss ball init + reach reward — exercises the
# phase-gated toss + overhead strike path (`create_ball_state_for_serve`,
# humanoid_smpl_im_mvae.py:526-560) from a shipped config
_register(_tennis(
    "federer_train_serve",
    "Serve practice: serve-toss ball init, reach reward (the reference's "
    "serve logic is exercised by the dual cfgs' serve_from handling; here "
    "a dedicated single-player stage)",
    dataclasses.replace(_STAGE1_ENV, init_ball_type="serve_toss",
                        num_envs=10240),
    CONFIGS["federer_train_stage_1"].v2p,
    warm_start="federer_train_stage_1",
))

# dual-player rally configs (federer_djokovic.yaml, nadal_federer.yaml):
# TWO player identities — per-lane MVAE/handedness/residual tables/π_low,
# and the two-hand backhand flag set for the two-handed player of the pair
# (`federer_djokovic.yaml:65`, `nadal_federer.yaml:64`)
for _pair in (("federer", "djokovic"), ("nadal", "federer")):
    _register(_tennis(
        f"{_pair[0]}_{_pair[1]}",
        f"Dual-player rally: {_pair[0]} (near) vs {_pair[1]} (far) "
        f"({_pair[0]}_{_pair[1]}.yaml)",
        dataclasses.replace(CONFIGS["federer_train_stage_3"].env_tennis,
                            num_envs=15360,
                            reset_candidates=0),  # lane-paired serves
        CONFIGS["federer_train_stage_3"].v2p,
        player=_pair[0], player_b=_pair[1], dual=True,
    ))


# ---- MVAE (vid2player/motion_vae/config.py) ----------------------------------

for _p in ("federer", "djokovic", "nadal"):
    _register(RunConfig(name=f"mvae_{_p}", kind="mvae",
                        description=f"MotionVAE training for {_p} "
                        "(motion_vae/config.py versions)",
                        mvae_version=_p, player=_p))


def get_config(name: str) -> RunConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"unknown config '{name}'; available: {sorted(CONFIGS)}")
    return CONFIGS[name]
