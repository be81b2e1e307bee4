"""Named training configurations of the JAX package that the port runs.

The values are copied from ``vid2player3d_tpu/cli/configs.py`` (the port has
no CLI yet); each constant names its source lines there. `preset(name)`
returns a configuration's (env config, learner config):

- `amass_im_dr` (`configs.py:99-118`): amass_im with domain randomization,
  body-mass and PD-gain scaling per env per epoch, obs and action noise on a
  linear schedule.
- `amass_im_corrupt` (`configs.py:125-137`): amass_im with a corrupted
  context (noisy and dropped joints) trained through the context IK.
- `federer_train_stage_1_dr` (`configs.py:213-232`): tennis stage 1 with the
  ball's restitution and drag perturbed per epoch, obs and action noise on a
  linear schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..learn.ppo import PPOConfig
from ..learn.v2p_ppo import V2PConfig
from .corrupt import TransformSpecs
from .domain_rand import RandSpec
from .humanoid_im import HumanoidImConfig
from .tennis import TennisConfig

# amass_im, `configs.py:64-75`
AMASS_IM_ENV = HumanoidImConfig(num_envs=8192, substeps=2, state_init="Hybrid",
                                hybrid_init_prob=1.0, context_length=32, context_padding=8,
                                residual_force_scale=31.85, termination_head_height=1.0)
AMASS_IM_PPO = PPOConfig(horizon=32, mini_epochs=6, minibatch_size=512, learning_rate=2e-5,
                         gamma=0.99, tau=0.95, e_clip=0.2, critic_coef=5.0, grad_norm=50.0,
                         sigma_init=-1.756, normalize_value=True)

# `configs.py:105-116`
AMASS_IM_DR_SPECS = (
    RandSpec(field="body_mass", distribution="uniform", rng=(0.9, 1.1), operation="scaling"),
    RandSpec(field="kp", distribution="uniform", rng=(0.85, 1.15), operation="scaling"),
    RandSpec(field="observations", distribution="gaussian", rng=(0.0, 0.002),
             operation="additive", schedule="linear", schedule_steps=3000),
    RandSpec(field="actions", distribution="gaussian", rng=(0.0, 0.01),
             operation="additive", schedule="linear", schedule_steps=3000),
)

# `configs.py:131-135`
AMASS_IM_CORRUPT_SPECS = TransformSpecs(noisy_joints_prob=0.5, noisy_joints_noise_std=0.02,
                                        noisy_joints_conf_std=0.02, noisy_joints_min_conf=0.1,
                                        mask_random_joints_prob=0.05)

# federer_train_stage_1, `configs.py:142-158`
STAGE1_ENV = TennisConfig(num_envs=10240, substeps=2, max_episode_length=600,
                          reward_type="reach", use_random_ball_target="discrete",
                          reset_reaction_nframes=70, reset_candidates=256)
STAGE1_V2P = V2PConfig(horizon=64, minibatch_size=16384, mini_epochs=6, learning_rate=1e-4,
                       sigma_init=-0.69, bounds_loss_coef=10.0, critic_coef=5.0, grad_norm=50.0)

# `configs.py:219-230`
STAGE1_DR_SPECS = (
    RandSpec(field="ball_restitution", distribution="uniform", rng=(0.95, 1.05),
             operation="scaling"),
    RandSpec(field="ball_base_cd", distribution="uniform", rng=(0.9, 1.1), operation="scaling"),
    RandSpec(field="observations", distribution="gaussian", rng=(0.0, 0.002),
             operation="additive", schedule="linear", schedule_steps=3000),
    RandSpec(field="actions", distribution="gaussian", rng=(0.0, 0.01),
             operation="additive", schedule="linear", schedule_steps=3000),
)

PRESETS: Dict[str, Tuple[object, PPOConfig]] = {
    "amass_im_dr": (dataclasses.replace(AMASS_IM_ENV, rand_specs=AMASS_IM_DR_SPECS),
                    AMASS_IM_PPO),
    "amass_im_corrupt": (dataclasses.replace(AMASS_IM_ENV, transform_specs=AMASS_IM_CORRUPT_SPECS),
                         dataclasses.replace(AMASS_IM_PPO, use_context_ik=True)),
    "federer_train_stage_1_dr": (dataclasses.replace(STAGE1_ENV, rand_specs=STAGE1_DR_SPECS),
                                 STAGE1_V2P),
}


def preset(name: str, **env_overrides):
    """(env config, learner config) of a named configuration; keyword
    arguments replace env config fields (e.g. `num_envs`)."""
    env_cfg, learner_cfg = PRESETS[name]
    return dataclasses.replace(env_cfg, **env_overrides), learner_cfg
