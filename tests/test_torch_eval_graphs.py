"""The evaluation rollouts replayed from CUDA graphs (``vid2player3d_torch/
eval.py`` and ``mvae/eval.py``), on the CPU, where each `StaticGraph` runs its
step on the static tensors as it is (the path the card captures and
replays). `V2PPPO.graphed` and `ImitationPPO.graphed` are forced true here
to reach the staged path; on the card they are true for every config
without a mesh, domain randomization or the context IK.

- The staged `eval_tennis` (with `per_env`) and `export_rollout` against the
  eager ones from one seed, bit for bit: stage 1, a two-hand single-player
  env (a left-handed spec, the IK inside the step) and a `DualTennisEnv`
  with a two-handed lane (both policies, the serve and hand-off flights).
  The staged path draws each step from the seeded copy's generator through
  `step_draws`, the eager one inside `step`, so a draw out of order shows.
- The staged `eval_imitation` (two rollouts of two segments) and
  `export_imitation_rollout` against the eager ones, bit for bit.
- The staged random walk against the eager one, seeded and fed, bit for bit.
- Every staged body dispatches no op a capture refuses; a second call with
  the same record set takes no new key, new params take one; `evaluate` on
  a `_dr` or context-IK learner stays eager.
- The eager rollout's seeded copy makes its candidate resets anew (a cached
  candidate env drew from the agent's env's generator).

Sizes of tests/test_torch_eval.py: 4 envs, trunks (64, 32), f32; the MVAE
at test widths and a random full-width pi_low, made from seeds. No JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_dispatch import _REFUSED, _Ops
from vid2player3d_torch import eval as E
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import (DualTennisEnv, HumanoidImConfig, HumanoidImEnv,
                                     TennisConfig, TennisEnv)
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.learn import running_norm as RN
from vid2player3d_torch.learn.networks import ImitatorNet
from vid2player3d_torch.mvae import eval as ME
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import TennisBallGenerator
from vid2player3d_torch.utils import graphs

torch.set_num_threads(1)

N = 4
LEARNER = dict(horizon=4, minibatch_size=8, mini_epochs=1, actor_units=(64, 32),
               critic_units=(64, 32), compute_dtype="f32")
TENNIS = dict(num_envs=N, substeps=2, max_episode_length=12, reset_reaction_nframes=6,
              reward_type="reach", use_random_ball_target="discrete")
# stage 3's flags with the two-hand backhand, as tests/test_torch_dual_graphs.py
TWO_HAND = dict(num_envs=N, substeps=2, max_episode_length=5, reset_reaction_nframes=6,
                ball_reaction_force=True, ball_body_contact=True,
                reward_type="return_w_estimate", use_random_ball_target="continuous",
                reset_candidates=2, two_hand_backhand=True, two_hand_iters=4)
DUAL = dict(num_envs=N, substeps=2, max_episode_length=5, ball_reaction_force=True,
            ball_body_contact=True, reward_type="return_w_estimate",
            use_random_ball_target="continuous", reset_candidates=0, two_hand_iters=4)
# (eval steps, export steps): episodes end and reset inside each rollout
STEPS = {"stage1": (16, 12), "two_hand": (6, 6), "dual": (6, 6)}
IM = dict(num_envs=N, substeps=2, context_length=8)


def _frames(seed):
    rng = np.random.default_rng(seed)
    ft = (rng.standard_normal((64, 288)) * 0.05).astype(np.float32)
    ft[:, 2] = 0.95
    return ft


def _pi_low(seed):
    net = ImitatorNet(num_actions=75, generator=torch.Generator().manual_seed(seed))
    return FrozenImitator(net=net, obs_norm=RN.RunningNormState.create(734, "cpu"))


@pytest.fixture(scope="module")
def pool():
    return TennisBallGenerator(num_candidates=256, seed=0, device="cpu")


def _spec(seed, **kw):
    return P.make_random_spec(seed, hidden=64, experts=3, device="cpu", **kw)


def _tennis_agent(pool, case):
    if case == "dual":
        specs = (dataclasses.replace(_spec(0, player="nadal"), righthand=False),
                 _spec(1, player="federer"))
        env = DualTennisEnv(TennisConfig(**DUAL), specs, (_frames(0), _frames(1)),
                            ball_generator=pool, pi_low=_pi_low(0), pi_low_b=_pi_low(1),
                            two_hand_lanes=(True, False), device="cpu")
    elif case == "two_hand":
        env = TennisEnv(TennisConfig(**TWO_HAND),
                        dataclasses.replace(_spec(0, player="nadal"), righthand=False),
                        _frames(0), ball_generator=pool, pi_low=_pi_low(0), device="cpu")
    else:
        env = TennisEnv(TennisConfig(**TENNIS), _spec(0), _frames(0), ball_generator=pool,
                        pi_low=_pi_low(0), device="cpu")
    agent = V2PPPO(env, V2PConfig(**LEARNER, num_policies=2 if case == "dual" else 1),
                   seed=3, device="cpu")
    ts = agent.init_state()
    ts.obs_norm = _obs_norm(agent.obs_dim, 1)
    return agent, ts


def _obs_norm(dim, seed):
    """A non-trivial running normalizer."""
    rng = np.random.default_rng(seed)
    return RN.RunningNormState(
        n=torch.tensor(10.0), mean=torch.tensor((rng.standard_normal(dim) * 0.1)
                                                .astype(np.float32)),
        var=torch.tensor(rng.uniform(0.5, 2.0, dim).astype(np.float32)))


class _Checked(graphs.StaticGraph):
    """A `StaticGraph` whose body's second run goes under the dispatch check
    (on the card the first run is the eager one before the capture, which
    makes the lazily built parts: the candidate env, its rest pose); the
    names of every staged body's ops gather in `seen`."""

    seen = set()

    def __init__(self, body, device):
        runs = [0]

        def checked():
            runs[0] += 1
            if runs[0] != 2:
                return body()
            with _Ops() as ops:
                body()
            _Checked.seen |= ops.names
        super().__init__(checked, device)


@pytest.fixture
def staged(monkeypatch):
    """Force the learners' graphed predicate; every StaticGraph checked.
    Yields a function that turns the staged path on or off."""
    on = [False]
    for cls in (V2PPPO, ImitationPPO):
        monkeypatch.setattr(cls, "graphed", property(lambda self: on[0]))
    monkeypatch.setattr(graphs, "StaticGraph", _Checked)
    _Checked.seen = set()

    def set_staged(value):
        on[0] = value
    yield set_staged
    assert sorted(n for n in _Checked.seen if n in _REFUSED) == []


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


def _same_npz(a, b):
    a, b = dict(np.load(a)), dict(np.load(b))
    _same_tree(a, b)
    return a


@pytest.mark.parametrize("case", list(STEPS))
def test_staged_tennis_eval_and_export_equal_eager(pool, case, staged, tmp_path):
    """`eval_tennis(per_env=True)` and `export_rollout` (with a two-handed
    lane: the post-hoc refinement after it) staged = eager bit for bit:
    the report, the per-env stats and every exported array. One key per
    record set."""
    agent, ts = _tennis_agent(pool, case)
    n_eval, n_export = STEPS[case]
    got = {}
    for on in (False, True):
        staged(on)
        got[on] = (E.eval_tennis(agent, num_steps=n_eval, per_env=True, ts=ts),
                   E.export_rollout(agent, str(tmp_path / f"{on}.npz"), num_steps=n_export,
                                    ts=ts))
    _same_tree(got[False][0][0], got[True][0][0])
    _same_tree(got[False][0][1], got[True][0][1])
    rec = _same_npz(got[False][1], got[True][1])
    assert rec["done"].any(), "no episode ended"
    assert {r: s.step.captures for r, s in agent._eval_st.items()} == {
        E._tennis_eval_record: 1, E._tennis_export_record: 1}
    assert agent._st is None
    if agent.env.cfg.reset_candidates:
        # the staged steps cached the agent's env's candidate env; an eager
        # evaluation after them still draws its candidates from its seed
        staged(False)
        rep, pe = E.eval_tennis(agent, num_steps=n_eval, per_env=True, ts=ts)
        _same_tree(rep, got[False][0][0])
        _same_tree(pe, got[False][0][1])


def test_record_sets_replay_and_new_params_recapture(pool, staged):
    """Stage 1: a record set called again with the same shape replays (no
    new key), as the command line's repeated `eval_tennis` does, and leaves
    the other record set's graph alone; its raw records equal the eager
    ones from another seed; new params (a loaded checkpoint) take one new
    key; a new step count makes the record set's statics anew."""
    agent, ts = _tennis_agent(pool, "stage1")
    staged(True)
    ev, ex = E._tennis_eval_record, E._tennis_export_record
    E._tennis_rollout(agent, ts, 4321, 6, None, ev)
    E._tennis_rollout(agent, ts, 7, 6, None, ex)
    first = agent._eval_st[ev]
    g = E._tennis_rollout(agent, ts, 5, 6, None, ev)
    e = E._tennis_rollout_eager(agent, ts, 5, 6, None, ev)
    np.testing.assert_array_equal(e[1], g[1])
    _same_tree(e[2], g[2])
    assert agent._eval_st[ev] is first and first.step.captures == 1
    ts.params = {k: v.clone() for k, v in ts.params.items()}
    E._tennis_rollout(agent, ts, 5, 6, None, ev)
    assert first.step.captures == 2 and agent._eval_st[ex].step.captures == 1
    E._tennis_rollout(agent, ts, 5, 3, None, ev)
    assert agent._eval_st[ev] is not first and agent._eval_st[ev].shape == (3, N)


@pytest.fixture(scope="module")
def imitation():
    env = HumanoidImEnv(HumanoidImConfig(**IM),
                        make_synthetic_motion_lib(num_motions=2, T=60, fps=30.0, seed=0,
                                                  device="cpu"), device="cpu")
    agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, mini_epochs=1), seed=7,
                         device="cpu")
    ts = agent.init_state()
    ts.obs_norm = _obs_norm(agent.obs_dim, 2)
    return agent, ts


def test_staged_imitation_eval_and_export_equal_eager(imitation, staged, tmp_path):
    """`eval_imitation` (two rollouts of two 8-step segments, the context
    rebuilt between them) and `export_imitation_rollout` (12 steps over two
    segments) staged = eager bit for bit; one key per record set over
    the four segments."""
    agent, ts = imitation
    got = {}
    for on in (False, True):
        staged(on)
        got[on] = (E.eval_imitation(agent, num_rollouts=2, ts=ts, max_steps=16),
                   E.export_imitation_rollout(agent, str(tmp_path / f"{on}.npz"), num_steps=12,
                                              ts=ts))
    _same_tree(got[False][0], got[True][0])
    assert 0.0 < got[True][0]["alive_ratio"] <= 1.0
    _same_npz(got[False][1], got[True][1])
    sts = agent._eval_st
    assert {r: s.step.captures for r, s in sts.items()} == {E._im_eval_record: 1,
                                                           E._im_export_record: 1}


def test_staged_random_walk_equals_eager(staged):
    """`random_walk_rollout`'s staged steps = the eager ones bit for bit,
    from a seed and fed normals, at a latent scale of 0.5."""
    spec = _spec(2)
    init = _frames(3)[:N]
    fed = np.random.default_rng(4).standard_normal((10, N, spec.latent_size)).astype(np.float32)
    for draws in (None, fed):
        e = ME._random_walk_eager(spec, init, 10, 5, 0.5, draws)
        g = ME._random_walk_graphed(spec, init, 10, 5, 0.5, draws)
        for a, b in zip(e, g):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ME._random_walk_eager(spec, init, 10, 6, 0.5, None)[0], e[0])
    # on the CPU the public function runs the eager steps
    np.testing.assert_array_equal(ME.random_walk_rollout(spec, init, 10, 5, 0.5)[0],
                                  ME._random_walk_eager(spec, init, 10, 5, 0.5, None)[0])


def test_dr_and_context_ik_evaluate_eagerly(pool, monkeypatch):
    """`evaluate` on `federer_train_stage_1_dr` and `amass_im_corrupt`. The
    eager evaluation (the CPU's path and the oracle) steps the agent's own
    env with no randomization noise, the context IK on the full-confidence
    context; on a card their predicate is true (the learners' device set to
    the card's type without touching one), and the staged evaluation equals
    the eager one bit for bit, one capture per record set, its steps free of
    the ops a capture refuses."""
    env_cfg, v2p_cfg = preset("federer_train_stage_1_dr", num_envs=N, reset_candidates=2)
    env = TennisEnv(env_cfg, _spec(0), _frames(0), ball_generator=pool, pi_low=_pi_low(0),
                    device="cpu")
    tennis = V2PPPO(env, dataclasses.replace(v2p_cfg, **LEARNER), device="cpu")
    env_cfg, ppo_cfg = preset("amass_im_corrupt", num_envs=N, context_length=4)
    im = ImitationPPO(HumanoidImEnv(env_cfg, make_synthetic_motion_lib(
        num_motions=2, T=60, fps=30.0, seed=0, device="cpu"), device="cpu"),
        dataclasses.replace(ppo_cfg, horizon=4, minibatch_size=8), device="cpu")
    states = {}
    for agent in (tennis, im):
        states[agent] = agent.init_state()
        agent.device = torch.device("cuda", 0)
        assert agent.graphed
        agent.device = torch.device("cpu")
    on = [False]
    for cls in (V2PPPO, ImitationPPO):
        monkeypatch.setattr(cls, "graphed", property(lambda self: on[0]))
    monkeypatch.setattr(graphs, "StaticGraph", _Checked)
    _Checked.seen = set()
    for agent, ts in states.items():
        got = []
        for on[0] in (False, True):
            if agent is tennis:
                got.append(E.evaluate(agent, num_epochs=1, steps_per_epoch=3, ts=ts))
            else:
                got.append(E.eval_imitation(agent, num_rollouts=1, ts=ts, max_steps=4))
        _same_tree(got[0], got[1])
        assert all(v is None or np.isfinite(v) for v in got[1].values())
        assert [s.step.captures for s in agent._eval_st.values()] == [1]
    assert sorted(n for n in _Checked.seen if n in _REFUSED) == []
