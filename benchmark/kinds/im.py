"""The imitation configurations (`amass_im` and its kin): `ImitationPPO` over
`HumanoidImEnv` on a motion library the benchmark makes from the seed."""

from __future__ import annotations

import os
from typing import Dict

import torch

from .. import weights
from .common import as_config, check_program_config, clamp_minibatch


def make_inputs(cfg: dict, seed: int, workdir: str) -> Dict:
    """The cell's inputs, made by the benchmark: the motion library (written
    as the port's `.npz`, which the port and the reference both read) and the
    seed of every generator."""
    from ..reference.port.data.synthetic import make_synthetic_motion_lib

    m = cfg["motions"]
    lib = make_synthetic_motion_lib(num_motions=m["num_motions"], T=m["frames"], fps=m["fps"],
                                    seed=seed % 2 ** 31, device="cpu")
    path = os.path.join(workdir, "motions.npz")
    lib.save(path)
    return {"motion_file": path, "seed": seed}


def initial_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    return weights.actor_critic(cfg["network"], gen, device)


def build_program(cfg: dict, inputs: Dict, device, num_envs=None):
    """The port's learner, built as `python -m vid2player3d_torch --cfg <name>
    --motion_file <file> --seed <seed>` builds it, and its train state on the
    benchmark's weights."""
    from vid2player3d_torch.cli import run as cli
    from vid2player3d_torch.cli.configs import get_config

    run_cfg = get_config(cfg["program_config"])
    check_program_config(cfg, {"env": run_cfg.env_im, "ppo": run_cfg.ppo})
    argv = ["--cfg", cfg["program_config"], "--motion_file", inputs["motion_file"],
            "--seed", str(inputs["seed"])]
    if num_envs is not None:
        argv += ["--num_envs", str(num_envs)]
    args = cli.build_parser().parse_args(argv)
    agent = cli._build_im(run_cfg, args, device)
    return agent, agent.init_state(initial_params(cfg, inputs["seed"], device))


def build_reference(cfg: dict, inputs: Dict, device, params, num_envs=None):
    """The frozen reference's learner on the same inputs and weights, in
    float32 with float32 Adam moments, stepping every epoch eagerly."""
    from ..reference.port.data.motion_lib import MotionLib
    from ..reference.port.envs.humanoid_im import HumanoidImConfig, HumanoidImEnv
    from ..reference.port.learn.ppo import ImitationPPO, PPOConfig

    env_cfg = as_config(HumanoidImConfig, cfg["env"])
    if num_envs is not None:
        env_cfg = type(env_cfg)(**{**env_cfg.__dict__, "num_envs": num_envs})
    ppo_cfg = as_config(PPOConfig, clamp_minibatch({**cfg["ppo"], "compute_dtype": "f32"},
                                                   env_cfg.num_envs))
    lib = MotionLib.load(inputs["motion_file"], device=device)
    env = HumanoidImEnv(env_cfg, lib, rng=inputs["seed"], device=device)
    agent = ImitationPPO(env, ppo_cfg, seed=inputs["seed"], device=device)
    return agent, agent.init_state(params), [agent.net]


def flops_per_epoch(cfg: dict, num_envs=None) -> Dict[str, float]:
    """The networks' operations in one training epoch, by precision."""
    from ..flops import actor_critic_epoch

    n = cfg["network"]
    ppo = cfg["ppo"]
    envs = num_envs or cfg["env"]["num_envs"]
    return actor_critic_epoch(n["obs_dim"], n["num_actions"], n["actor_units"],
                              n["critic_units"], envs, ppo["horizon"],
                              ppo["mini_epochs"], ppo["minibatch_size"])
