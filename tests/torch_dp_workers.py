"""Rank functions for the data-parallel tests (`tests/test_torch_parallel.py`,
`test_torch_dp_imitation.py`, `test_torch_dp_tennis.py`).

`vid2player3d_torch.parallel.spawn` starts each rank in a new interpreter,
which imports its function by module name: this module imports torch and the
port only, so a rank never loads JAX. Every function takes the rank's mesh
first and returns plain CPU tensors and floats.
"""

import numpy as np
import torch

from vid2player3d_torch import parallel as PL


def mesh_helpers(mesh):
    """Each mesh helper on this rank's values: rank r holds r + arange."""
    r = mesh.rank
    tree = {"per_env": torch.arange(16.0).reshape(16, 1) + 100 * r,
            "scalar": torch.tensor(2.0 + r), "table": torch.arange(12.0).reshape(3, 4)}
    return {
        "rank": r, "dp": mesh.dp, "backend": mesh.backend,
        # the group's mesh asked for without a device: the one the rank pinned
        "default_device": str(PL.data_parallel_mesh().device),
        "sharded": PL.shard_leading_axis(tree, mesh),
        "replicated": PL.replicate(tree, mesh),
        "mean": PL.cross_shard_mean({"x": torch.full((3,), float(r)),
                                     "h": torch.full((2,), 1.0 + r, dtype=torch.bfloat16)}, mesh),
        "gathered": PL.all_gather_rows(torch.tensor([float(r), 10.0 * r]), mesh),
        "summed": PL.all_reduce_sum(torch.tensor([1.0, float(r)]), mesh),
    }


def _learner_out(agent, ts, m):
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.detach().clone() for k, v in ts.params.items()},
            "mu": [t.float().clone() for t in ts.opt_state.mu],
            "nu": [t.float().clone() for t in ts.opt_state.nu],
            "count": int(ts.opt_state.count), "num_minibatches": agent.num_minibatches,
            "obs_norm": (float(ts.obs_norm.n), ts.obs_norm.mean.clone(), ts.obs_norm.var.clone())}


def imitation_epoch(mesh, case):
    """One `ImitationPPO.train_epoch` of `case` (env and learner configs, motion
    ids, initial params and the global draws) on this rank's shard; with
    `mesh=None` the one-process run."""
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    torch.set_num_threads(1)
    lib = make_synthetic_motion_lib(**case["lib"], device="cpu")
    env = HumanoidImEnv(HumanoidImConfig(**case["env"]), lib, motion_ids=case["motion_ids"],
                        device="cpu")
    if mesh is not None:
        env = env.shard(mesh)
    agent = ImitationPPO(env, PPOConfig(**case["ppo"]), seed=case["seed"], mesh=mesh,
                         device="cpu")
    ts = agent.init_state(case["params"])
    ts, m = agent.train_epoch(ts, draws=case["draws"])
    return _learner_out(agent, ts, m)


def tennis_epoch(mesh, case):
    """One `V2PPPO.train_epoch` of a tennis `case`: the env's pieces (spec or
    specs, init frames, ball pool, frozen policies), configs, the initial
    params, and optionally the initial env state and last obs (global) and
    the global draws; with `mesh=None` the one-process run."""
    from vid2player3d_torch.envs import DualTennisEnv, TennisConfig, TennisEnv
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.utils import checkpoint as CK

    torch.set_num_threads(1)
    cls = DualTennisEnv if case.get("dual") else TennisEnv
    env_cfg = case["env"] if isinstance(case["env"], TennisConfig) else TennisConfig(**case["env"])
    env = cls(env_cfg, case["spec"], case["feats"], ball_generator=case["pool"], device="cpu",
              **case.get("env_kw", {}))
    if mesh is not None:
        env = env.shard(mesh)
    agent = V2PPPO(env, V2PConfig(**case["learner"]), seed=case["seed"], mesh=mesh,
                   device="cpu")
    ts = agent.init_state(params=case.get("params"))
    if "env_state" in case:
        state = CK.tennis_state_from_jax(case["env_state"])
        obs = torch.tensor(case["last_obs"])
        if mesh is not None:
            state, obs = PL.shard_leading_axis((state, obs), mesh)
        ts.env_state, ts.last_obs = state, obs
    ts.epoch = case.get("epoch", 0)
    ts, m = agent.train_epoch(ts, draws=case.get("draws"))
    out = _learner_out(agent, ts, m)
    out["joint_pos"] = agent.last_env.model.joint_pos.clone()
    out["ball_params"] = {k: float(v) for k, v in agent.last_env.ball_params._asdict().items()}
    out["val_norm"] = (float(ts.val_norm.n), ts.val_norm.mean.clone(), ts.val_norm.var.clone())
    out["last_obs"] = ts.last_obs.clone()
    return out


def run(fn, case, ranks: int = 2):
    """`fn` in one process (mesh None) and over `ranks` gloo ranks on the
    CPU; returns (one-process result, per-rank results)."""
    return fn(None, case), PL.spawn(fn, ranks, args=(case,), device="cpu", timeout_s=120.0)


def rows(x, rank: int, dp: int = 2):
    """Rank `rank`'s block of a global array."""
    n = x.shape[0] // dp
    return x[rank * n:(rank + 1) * n]


def interleaved_perm(perms: np.ndarray, mb_local: int) -> np.ndarray:
    """The one-process permutation whose minibatch i holds the samples of
    every shard's minibatch i: shard r's local index j is global r·n + j."""
    dp, n = perms.shape
    parts = [(perms[r] + r * n).reshape(-1, mb_local) for r in range(dp)]
    return np.concatenate(parts, axis=1).reshape(-1)
