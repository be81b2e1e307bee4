"""Multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m vid2player3d_torch.parallel.dryrun N [--device cpu] [--backend gloo]

Starts N ranks and runs, over their mesh, one epoch of each learner at tiny
sizes: the imitation PPO, the stage-1 tennis PPO with a frozen low-level
policy (MVAE decode, FK targets, pi_low, physics, the task machine), and
the dual rally with two player identities and per-rank minibatches. Every
metric must be finite on every rank. Prints each rank's metrics as one JSON
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import mesh as PM


def _finite(what: str, metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = {k: float(v) for k, v in metrics.items()}
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"{what}: non-finite metrics {bad}")
    return out


def _dryrun_rank(mesh: PM.DataParallelMesh) -> Dict[str, Dict[str, float]]:
    from ..data.synthetic import make_synthetic_motion_lib
    from ..envs import DualTennisEnv, HumanoidImConfig, HumanoidImEnv, TennisConfig, TennisEnv
    from ..learn import FrozenImitator, ImitationPPO, PPOConfig, V2PConfig, V2PPPO
    from ..tennis import player as P
    from ..tennis.ball import TennisBallGenerator

    dev, n = mesh.device, mesh.dp
    out = {}

    lib = make_synthetic_motion_lib(num_motions=2, T=30, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=2 * n, substeps=2), lib, rng=0,
                        device=dev).shard(mesh)
    agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=4 * n, mini_epochs=1),
                         seed=7, mesh=mesh)
    _, m = agent.train_epoch(agent.init_state())
    out["imitation"] = _finite("imitation", m)

    # the hierarchical tennis stack over the same mesh
    spec = P.make_random_spec(0, hidden=32, experts=2, device=dev)
    feats = (np.random.default_rng(0).standard_normal((8, P.FRAME_SIZE)) * 0.05
             ).astype(np.float32)
    feats[:, 2] = 0.95
    pi_low = FrozenImitator.zeros(device=dev).as_pi_low()
    env = TennisEnv(TennisConfig(num_envs=2 * n, substeps=2, max_episode_length=20), spec, feats,
                    ball_generator=TennisBallGenerator(num_candidates=256, seed=0, device=dev),
                    pi_low=pi_low, device=dev).shard(mesh)
    v2p = V2PPPO(env, V2PConfig(horizon=4, minibatch_size=4 * n, mini_epochs=1,
                                actor_units=(32,), critic_units=(32,)), seed=1, mesh=mesh)
    _, m = v2p.train_epoch(v2p.init_state())
    out["tennis_stage1"] = _finite("tennis_stage1", m)

    # the dual rally with two player identities (per-lane MVAE, handedness,
    # pi_low) and per-rank minibatches
    spec_b = dataclasses.replace(P.make_random_spec(1, player="nadal", hidden=32, experts=2,
                                                    device=dev), righthand=False)
    env = DualTennisEnv(TennisConfig(num_envs=2 * n, substeps=2, max_episode_length=20,
                                     two_hand_iters=2), (spec, spec_b), (feats, feats),
                        ball_generator=TennisBallGenerator(num_candidates=256, seed=0,
                                                           device=dev),
                        pi_low=pi_low, pi_low_b=pi_low, two_hand_lanes=(False, True),
                        device=dev).shard(mesh)
    dual = V2PPPO(env, V2PConfig(horizon=4, minibatch_size=4, mini_epochs=1, actor_units=(32,),
                                 critic_units=(32,), num_policies=2, minibatch_per_chip=True),
                  seed=2, mesh=mesh)
    _, m = dual.train_epoch(dual.init_state())
    out["dual_rally"] = _finite("dual_rally", m)
    return out


def dryrun_multichip(n: int, device=None, backend: Optional[str] = None,
                     timeout_s: float = PM.DEFAULT_TIMEOUT_S) -> List[Dict]:
    """The three epochs over `n` ranks (one per card over NCCL by default;
    `device="cpu"` gloo ranks on the CPU; ranks sharing a card pass
    `backend="gloo"` and the card). Returns each rank's metrics; raises if a
    rank fails or a metric is not finite."""
    return PM.spawn(_dryrun_rank, n, backend=backend, device=device, timeout_s=timeout_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vid2player3d_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default=None, help="'cpu', or the card the ranks share")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    for r, m in enumerate(dryrun_multichip(args.n, device=args.device, backend=args.backend)):
        print(json.dumps({"rank": r, **m}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
