"""The tennis epoch replayed from CUDA graphs (`V2PPPO._train_epoch_graphed`,
``vid2player3d_torch/utils/graphs.py``), on the CPU, where each `StaticGraph`
runs its step on the static tensors as it is (the path the card captures and
replays).

- The staged epoch against the eager one (`_train_epoch_eager`) from one
  state and one seed of each generator, bit for bit over two epochs, on the
  single-player configs the card graphs: stage 1 (reach, discrete targets,
  2 candidate resets), stage 2 (6 substeps, the wrist reaction force,
  ball-body contact, return_w_estimate, continuous targets), the serve toss,
  the phase-synchronized launch, the linear and adaptive lr schedules. Each
  case also holds the draw order of `TennisEnv.step_draws` (the env's
  generator feeds both epochs) and the staged steps free of the ops a
  capture refuses.
- `step_draws` against the eager step's own draws; a checkpoint loaded after
  a capture takes new keys; the configs that take the graphs; the returned
  state is a copy of the statics.

The envs are the port's halves of `tests/test_torch_tennis_env.py`'s
`build_envs` over one `make_shared()` for the module (the JAX package makes
the shared weights and ball pool there and runs nothing else here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_graphs import _refused
from test_torch_tennis import _port_spec
from test_torch_tennis_env import build_envs, make_shared
from vid2player3d_torch import parallel
from vid2player3d_torch.envs import DualTennisEnv, TennisConfig, TennisEnv
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import V2PConfig, V2PPPO
from vid2player3d_torch.parallel import mesh as PM
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

# the sizes of tests/test_torch_v2p.py: 4 envs, horizon 4, minibatch 8, two
# mini-epochs, trunks (64, 32), f32; episodes of 5 steps and reactions of 6
# frames, so the two epochs' 8 steps run the masked reset and the reaction
# transition
ENV = dict(num_envs=4, substeps=2, max_episode_length=5, reset_reaction_nframes=6)
LEARNER = dict(horizon=4, minibatch_size=8, mini_epochs=2, actor_units=(64, 32),
               critic_units=(64, 32), compute_dtype="f32")
STAGE1 = dict(ENV, reward_type="reach", use_random_ball_target="discrete", reset_candidates=2)
CASES = {
    "stage1": (STAGE1, "constant"),
    "stage2": (dict(ENV, substeps=6, ball_reaction_force=True, ball_body_contact=True,
                    reward_type="return_w_estimate", reset_candidates=2), "constant"),
    "serve_toss": (dict(STAGE1, init_ball_type="serve_toss"), "constant"),
    "sync_launch": (dict(STAGE1, sync_launch=True, sync_flight_frames=4.0,
                         use_random_ball_target="continuous", reset_candidates=0), "constant"),
    "linear_lr": (STAGE1, "linear"),
    "adaptive_lr": (STAGE1, "adaptive"),
}


@pytest.fixture(scope="module")
def shared():
    return make_shared()


def _agent(shared, env_kw, schedule="constant"):
    _, tenv = build_envs(shared, **env_kw)
    return V2PPPO(tenv, V2PConfig(**LEARNER, lr_schedule=schedule, lr_decay_epochs=3,
                                  aux_dof_res_coef=0.01), seed=3, device="cpu")


def _two_states(agent):
    """Two train states from one state of the env's generator."""
    g = agent.env.generator.get_state()
    a = agent.init_state()
    agent.env.generator.set_state(g)
    return a, agent.init_state()


def _assert_same(a, ma, b, mb):
    assert list(ma) == list(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]) or (ma[k].isnan() and mb[k].isnan()), (k, ma[k], mb[k])
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0, msg=k)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for f in ("n", "mean", "var"):
        assert torch.equal(getattr(a.obs_norm, f), getattr(b.obs_norm, f)), f
        assert torch.equal(getattr(a.val_norm, f), getattr(b.val_norm, f)), f
    for x, y in zip(PM.tree_leaves(a.env_state), PM.tree_leaves(b.env_state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.last_obs, b.last_obs)
    assert torch.equal(a.lr, b.lr) and a.epoch == b.epoch


@pytest.mark.parametrize("case", list(CASES))
def test_staged_epoch_equals_eager(shared, case):
    """Two epochs from one state, the env's generator set to one state
    before each pair: metrics, params, moments, count, both norms, env
    state, last obs and lr bit for bit (the staged steps take their draws
    from `step_draws`, the eager ones inside `step`, so a draw out of order
    shows). One capture per graph; the staged steps dispatch no op a
    capture refuses."""
    env_kw, schedule = CASES[case]
    agent = _agent(shared, env_kw, schedule)
    a, b = _two_states(agent)
    for _ in range(2):
        g = agent.env.generator.get_state()
        a, ma = agent._train_epoch_eager(a)
        agent.env.generator.set_state(g)
        b, mb = agent._train_epoch_graphed(b)
        _assert_same(a, ma, b, mb)
        assert float(mb["grad_skip"]) == 0.0
    assert not torch.equal(a.obs_norm.mean, torch.zeros_like(a.obs_norm.mean))
    st = agent._st
    assert (st.step.captures, st.update.captures) == (1, 1)
    st.row.zero_()
    assert _refused(st.step.body) == []
    st.row.zero_()
    assert _refused(st.update.body) == []


@pytest.mark.parametrize("case", ["stage1", "stage2", "serve_toss"])
def test_step_draws_are_the_steps_own(shared, case):
    """`step(draws=step_draws())` equals `step(draws=None)` from one state
    of the env's generator, over three steps through a masked reset, and
    leaves the generator where the eager step leaves it."""
    _, env = build_envs(shared, **dict(CASES[case][0], max_episode_length=2))
    state0, _ = env.reset_all()
    act = torch.tensor(np.random.default_rng(0).standard_normal((3, 4, env.num_actions)) * 0.5,
                       dtype=torch.float32)
    g = env.generator.get_state()
    outs = []
    for given in (False, True):
        env.generator.set_state(g)
        state, got = state0, []
        for t in range(3):
            state, out = env.step(state, act[t], env.step_draws() if given else None)
            got.append((PM.tree_leaves(state), out.obs, out.reward, out.done))
        outs.append((got, env.generator.get_state()))
    (eager, g_eager), (staged, g_staged) = outs
    assert torch.equal(g_eager, g_staged)
    for e, s in zip(eager, staged):
        for x, y in zip(PM.tree_leaves(e), PM.tree_leaves(s)):
            assert torch.equal(x, y)
    draws = env.step_draws()
    assert ("ball_idx" in draws["reset"]) == (case != "serve_toss")
    assert draws["reset"]["root_xy_u"].shape == (2, 2) and draws["tt"].dtype == torch.int64


def test_checkpoint_after_capture_recaptures(shared, tmp_path):
    """A checkpoint loaded into a learner that has captured gives new params
    and moments, so both graphs take a new key; the epoch from it equals the
    eager epoch from the same file bit for bit."""
    agent = _agent(shared, STAGE1)
    ts, _ = agent._train_epoch_graphed(agent.init_state())
    st = agent._st
    keys = (st.step.key, st.update.key)
    path = str(tmp_path / "v2p.npz")
    agent.save_checkpoint(path, ts)
    g = agent.env.generator.get_state()
    a = agent.load_checkpoint(path)
    a, ma = agent._train_epoch_graphed(a)
    assert (st.step.captures, st.update.captures) == (2, 2)
    assert st.step.key != keys[0] and st.update.key != keys[1]
    agent.env.generator.set_state(g)
    b, mb = agent._train_epoch_eager(agent.load_checkpoint(path))
    _assert_same(a, ma, b, mb)
    assert a.epoch == 2


def test_returned_state_is_a_copy(shared, monkeypatch):
    """The epoch's env state and last obs, and `rollout`'s trajectory and
    state on the graphed path, are copies: the next epoch leaves them as
    they were."""
    agent = _agent(shared, STAGE1)
    ts, _ = agent._train_epoch_graphed(agent.init_state())
    st = agent._st
    statics = {t.data_ptr() for t in PM.tree_leaves((st.state, st.obs, st.traj))}
    assert not statics & {t.data_ptr() for t in PM.tree_leaves((ts.env_state, ts.last_obs))}
    kept = [t.clone() for t in PM.tree_leaves((ts.env_state, ts.last_obs))]
    monkeypatch.setattr(V2PPPO, "graphed", property(lambda self: True))
    traj, env_state, obs = agent.rollout(ts)
    assert agent._st is st and st.step.captures == 1
    assert not statics & {t.data_ptr() for t in PM.tree_leaves((traj, env_state, obs))}
    agent._train_epoch_graphed(ts)
    for x, y in zip(kept, PM.tree_leaves((ts.env_state, ts.last_obs))):
        assert torch.equal(x, y)
    assert set(traj["extras"]) == set(TennisEnv.EXTRAS)
    assert traj["sub_rewards"].shape[-1] == agent.env.num_sub_rewards


GRAPHED = ("federer_train_stage_1", "federer_train_stage_2", "federer_train_stage_3",
           "djokovic_train_stage_1", "nadal_train_stage_2", "federer_train_stage_1a",
           "federer_train_stage_2a", "federer_train_stage_2b", "federer_train_stage_2c",
           "federer_train_stage_1sync", "federer_train_stage_2sync", "federer_train_serve",
           "federer", "djokovic", "nadal", "federer_train_stage_1_dr")


@pytest.fixture(scope="module")
def port_parts(shared):
    """The port's MVAE spec, init frames, ball pool and frozen π_low."""
    jspec, feats, jgen, _, tfrozen = shared
    return _port_spec(jspec), feats, CK.ball_pool_from_jax(jgen, device="cpu"), tfrozen


@pytest.mark.parametrize("name", GRAPHED)
def test_which_configs_take_the_graphs(port_parts, name):
    """On a card the single-player configs replay their epochs from graphs,
    the two-hand `djokovic` and `nadal` and domain randomization included.
    The predicate reads the config and the device only (here the device is
    set to the card's type without touching one)."""
    spec, feats, pool, pi_low = port_parts
    env_cfg, v2p_cfg = preset(name, num_envs=4, reset_candidates=2)
    env = TennisEnv(env_cfg, spec, feats, ball_generator=pool, pi_low=pi_low, device="cpu")
    agent = V2PPPO(env, dataclasses.replace(v2p_cfg, **LEARNER), device="cpu")
    assert not agent.graphed
    agent.device = torch.device("cuda", 0)
    assert agent.graphed


def test_dual_mesh_and_cpu_stay_eager(port_parts):
    """The dual rallies (two policies on a `DualTennisEnv`, `nadal_federer`
    and `federer_djokovic`) replay their epochs from graphs on a card; a
    learner over a mesh (domain-randomized or not) stays eager there, and
    any learner on the CPU is eager."""
    spec, feats, pool, pi_low = port_parts
    duals = []
    for name, lanes in (("nadal_federer", (True, False)), ("federer_djokovic", (False, True))):
        env_cfg, v2p_cfg = preset(name, num_envs=4)
        dual = DualTennisEnv(env_cfg, (dataclasses.replace(spec, righthand=False), spec),
                             (feats, feats), ball_generator=pool, pi_low=pi_low,
                             two_hand_lanes=lanes, device="cpu")
        duals.append(V2PPPO(dual, dataclasses.replace(v2p_cfg, **LEARNER, num_policies=2),
                            device="cpu"))
    mesh = parallel.data_parallel_mesh(device="cpu")
    env = TennisEnv(TennisConfig(**STAGE1), spec, feats, ball_generator=pool, pi_low=pi_low,
                    device="cpu")
    meshed = V2PPPO(env.shard(mesh), V2PConfig(**LEARNER), mesh=mesh)
    env_cfg, _ = preset("federer_train_stage_1_dr", num_envs=4, reset_candidates=2)
    dr_env = TennisEnv(env_cfg, spec, feats, ball_generator=pool, pi_low=pi_low, device="cpu")
    meshed_dr = V2PPPO(dr_env.shard(mesh), V2PConfig(**LEARNER), mesh=mesh)
    for agent in duals + [meshed, meshed_dr]:
        assert not agent.graphed
        agent.device = torch.device("cuda", 0)
        assert agent.graphed == (agent not in (meshed, meshed_dr))
