"""The single-player tennis configurations (`federer_train_stage_1` and its
kin): `V2PPPO` over `TennisEnv`, with the federer-width MotionVAE decoder
(K2), the FK targets (K3), a frozen pi_low and a ball pool, every weight and
input made by the benchmark from the seed.

The learner is built from the same classes as the command line's
`_build_tennis` (`TennisEnv`, `V2PPPO`, the pool, the frozen pi_low), on the
benchmark's MotionVAE, pi_low and pool: without trained files the command
line would fall back to a test-width MotionVAE and an all-zero pi_low.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

from .. import weights
from .common import as_config, check_program_config, clamp_minibatch


def _mvae_leaves(m: dict):
    """(name, shape, std) of the MotionVAE decoder's leaves, in the port's
    naming: the gate MLP (fan-in normal), the three blended-expert layers
    (he-uniform over E·in, drawn here as a normal of the same variance) and
    their 0.01 biases (set by `_mvae_biases`)."""
    frame, latent, hidden, experts, gate = (m["frame_size"], m["latent_size"],
                                            m["hidden_size"], m["num_experts"],
                                            m["gate_hidden"])
    out = frame + (2 if m["predict_phase"] else 0)
    d_in, inter = latent + frame, latent + hidden
    leaves = []
    for name, (a, b) in (("gate1", (d_in, gate)), ("gate2", (gate, gate)),
                         ("gate3", (gate, experts))):
        leaves.append((f"decoder.{name}.weight", (b, a), 1.0 / np.sqrt(a) / 0.8796256610342398))
        leaves.append((f"decoder.{name}.bias", (b,), 0.0))
    for name, (a, b) in (("moe0", (d_in, hidden)), ("moe1", (inter, hidden)),
                         ("moe2", (inter, out))):
        leaves.append((f"decoder.{name}.w", (experts, a, b),
                       np.sqrt(2.0 / (experts * a)) / 0.8796256610342398))
    return leaves


def make_inputs(cfg: dict, seed: int, workdir: str) -> Dict:
    """The ball pool (simulated by the reference's code from the seed and
    written as the port's `.npz`) and the MotionVAE's init frames, as the
    command line makes them without a trained MotionVAE."""
    from ..reference.port.tennis.ball import TennisBallGenerator

    pool = TennisBallGenerator({"ball_traj_length": cfg["pool"]["traj_length"]},
                               num_candidates=cfg["pool"]["candidates"], seed=seed % 2 ** 31,
                               device="cpu")
    path = os.path.join(workdir, "pool.npz")
    pool.save_npz(path)
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((cfg["init_frames"], cfg["mvae"]["frame_size"]))
              * 0.05).astype(np.float32)
    frames[:, 2] = 0.95
    return {"pool_file": path, "init_frames": frames, "seed": seed}


def initial_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The policy's, the MotionVAE decoder's and pi_low's weights, drawn on
    the device from the seed, one call per network."""
    gen = torch.Generator(device=device).manual_seed(seed)
    policy = weights.actor_critic(cfg["network"], gen, device)
    mvae = weights.draw(_mvae_leaves(cfg["mvae"]), gen, device)
    for name in ("moe0", "moe1", "moe2"):
        w = mvae[f"decoder.{name}.w"]
        mvae[f"decoder.{name}.b"] = torch.full((w.shape[0], w.shape[2]), 0.01, device=device)
    pi_low = weights.actor_critic(cfg["pi_low"], gen, device)
    return {"policy": policy, "mvae": mvae, "pi_low": pi_low}


def _mvae_module(P, cfg, mvae_weights, device):
    m = cfg["mvae"]
    from_pkg = P.make_random_spec(0, player=cfg["player"], latent_size=m["latent_size"],
                                  hidden=m["hidden_size"], experts=m["num_experts"],
                                  predict_phase=m["predict_phase"], device=device)
    with torch.no_grad():
        params = dict(from_pkg.decoder.named_parameters())
        for k, v in mvae_weights.items():
            params[k].copy_(v)
    return from_pkg


def _unit_norm(rn, dim: int, device):
    """A running normalizer of zero mean and unit variance with the weight
    of 10^6 samples: the policy's inputs are clipped to 5 from the first
    epoch, as in every epoch after the first of a run from scratch (whose
    first epoch feeds the raw observations and, with untrained weights,
    drives states that explode; see PERF.md)."""
    return rn.RunningNormState(n=torch.tensor(1.0e6, device=device),
                               mean=torch.zeros(dim, device=device),
                               var=torch.ones(dim, device=device))


def _pi_low(frozen_cls, net_cls, rn, cfg, w, device):
    n = cfg["pi_low"]
    net = net_cls(num_actions=n["num_actions"], obs_dim=n["obs_dim"],
                  actor_units=tuple(n["actor_units"]), critic_units=tuple(n["critic_units"]))
    net = net.to(device)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(w[k])
    return frozen_cls(net=net, obs_norm=_unit_norm(rn, n["obs_dim"], device))


def build_program(cfg: dict, inputs: Dict, device, num_envs=None):
    """The port's learner and its train state on the benchmark's weights."""
    from vid2player3d_torch.cli import run as cli
    from vid2player3d_torch.cli.configs import get_config
    from vid2player3d_torch.envs import TennisEnv
    from vid2player3d_torch.learn import FrozenImitator, V2PPPO
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    run_cfg = get_config(cfg["program_config"])
    check_program_config(cfg, {"env": run_cfg.env_tennis, "ppo": run_cfg.v2p})
    env_cfg = run_cfg.env_tennis
    if num_envs is not None:
        env_cfg = dataclasses.replace(env_cfg, num_envs=num_envs)
    v2p_cfg = cli._clamp_minibatch(run_cfg.v2p, env_cfg.num_envs)
    w = initial_weights(cfg, inputs["seed"], device)
    spec = _mvae_module(P, cfg, w["mvae"], device)
    pi_low = _pi_low(FrozenImitator, ImitatorNet, RN, cfg, w["pi_low"], device).as_pi_low()
    pool = TennisBallGenerator.from_npz(inputs["pool_file"], device=device)
    env = TennisEnv(env_cfg, spec, inputs["init_frames"], ball_generator=pool, pi_low=pi_low,
                    seed=inputs["seed"], device=device)
    agent = V2PPPO(env, v2p_cfg, seed=inputs["seed"], device=device)
    return agent, agent.init_state(params=w["policy"],
                                   warm={"obs_norm": _unit_norm(RN, env.obs_dim, device)})


def build_reference(cfg: dict, inputs: Dict, device, params, num_envs=None):
    """The frozen reference's learner on the same inputs and weights: the
    policy in float32 with float32 Adam moments, the MotionVAE decode and
    pi_low in float32 with TF32 off, every epoch eager."""
    from ..reference.port.envs.tennis import TennisConfig, TennisEnv
    from ..reference.port.learn import running_norm as RN
    from ..reference.port.learn.frozen import FrozenImitator
    from ..reference.port.learn.networks import ImitatorNet
    from ..reference.port.learn.v2p_ppo import V2PConfig, V2PPPO
    from ..reference.port.tennis import player as P
    from ..reference.port.tennis.ball import TennisBallGenerator

    env_cfg = as_config(TennisConfig, cfg["env"])
    if num_envs is not None:
        env_cfg = dataclasses.replace(env_cfg, num_envs=num_envs)
    v2p_cfg = as_config(V2PConfig, clamp_minibatch({**cfg["ppo"], "compute_dtype": "f32"},
                                                   env_cfg.num_envs))
    w = initial_weights(cfg, inputs["seed"], device)
    spec = _mvae_module(P, cfg, w["mvae"], device)
    frozen = _pi_low(FrozenImitator, ImitatorNet, RN, cfg, w["pi_low"], device)
    pool = TennisBallGenerator.from_npz(inputs["pool_file"], device=device)
    env = TennisEnv(env_cfg, spec, inputs["init_frames"], ball_generator=pool,
                    pi_low=frozen.as_pi_low(), seed=inputs["seed"], device=device)
    agent = V2PPPO(env, v2p_cfg, seed=inputs["seed"], device=device)
    ts = agent.init_state(params=params, warm={"obs_norm": _unit_norm(RN, env.obs_dim, device)})
    return agent, ts, [agent.net]


def flops_per_epoch(cfg: dict, num_envs=None) -> Dict[str, float]:
    """The networks' operations in one training epoch, by precision: the
    policy (bf16 trunks, f32 heads, forward per env step and forward and
    backward per optimizer step), and per env step pi_low's forward (f32)
    and the MotionVAE decode (its gate in f32, K2's layers in TF32)."""
    from ..flops import actor_critic_epoch, actor_critic_forward, add, moe_linear

    n, ppo, m, lo = cfg["network"], cfg["ppo"], cfg["mvae"], cfg["pi_low"]
    envs = num_envs or cfg["env"]["num_envs"]
    T = ppo["horizon"]
    mb = min(ppo["minibatch_size"], envs * T)
    policy = actor_critic_epoch(n["obs_dim"], n["num_actions"], n["actor_units"],
                                n["critic_units"], envs, T, ppo["mini_epochs"], mb)
    low = actor_critic_forward(lo["obs_dim"], lo["num_actions"], lo["actor_units"],
                               lo["critic_units"], envs)
    low = {"f32": low["bf16"] + low["f32"]}
    d_in, inter = m["latent_size"] + m["frame_size"], m["latent_size"] + m["hidden_size"]
    out = m["frame_size"] + (2 if m["predict_phase"] else 0)
    k2 = moe_linear(envs, ((d_in, m["hidden_size"]), (inter, m["hidden_size"]), (inter, out)),
                    m["num_experts"])
    gate = 2.0 * envs * (d_in * m["gate_hidden"] + m["gate_hidden"] ** 2
                         + m["gate_hidden"] * m["num_experts"])
    step = add(low, {"tf32": k2["ops"], "f32": gate})
    return add(policy, add(step, scale=T))

