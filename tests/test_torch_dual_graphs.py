"""The two-hand and dual-rally tennis epochs replayed from CUDA graphs
(`V2PPPO._train_epoch_graphed`, ``vid2player3d_torch/utils/graphs.py``), on
the CPU, where each `StaticGraph` runs its step on the static tensors as it
is (the path the card captures and replays).

- The staged epoch against the eager one (`_train_epoch_eager`) from one
  state and one seed of each generator, bit for bit over two epochs: the
  dual rally (`DualTennisEnv` under the stage-3 dual flags, two policies, a
  left-handed two-hand lane and a right-handed one) and a single-player
  env with the two-hand backhand, left- and right-handed. Each case starts
  its two-hand rows in a backhand, so the IK's fix applies inside the
  captured step, and holds the staged steps free of the ops a capture
  refuses.
- `step(draws=step_draws())` against the eager step's own draws for both
  envs (the dual's serve draws and lane-by-lane init rows included).
- `batch_rigid_transform` and `optimize_two_hand_backhand` alone dispatch
  no refused op once their constants exist; the IK's rest pose is made
  once per model.

The dual env is `tests/test_torch_dual.py`'s `build_dual` (its JAX half is
built and never run here); the single-player env takes
`tests/test_torch_tennis_env.py`'s `make_shared` pieces.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_dual import DUAL, build_dual, make_players
from test_torch_graphs import _refused
from test_torch_tennis import _port_spec
from test_torch_tennis_env import make_shared
from test_torch_tennis_graphs import LEARNER, _assert_same, _two_states
from vid2player3d_torch.core import rot as R
from vid2player3d_torch.core import smpl as S
from vid2player3d_torch.envs import DualTennisEnv, TennisConfig, TennisEnv
from vid2player3d_torch.learn import V2PConfig, V2PPPO
from vid2player3d_torch.parallel import mesh as PM
from vid2player3d_torch.tennis import twohand as TH
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

# episodes of 5 steps, so the two epochs' 8 steps run the masked reset (the
# dual's with its serve)
DUAL_CASE = dict(DUAL, max_episode_length=5)
# stage 3's single-player flags with the two-hand backhand (`djokovic`,
# `nadal`) at test sizes: 2 substeps, 2 candidate resets, reactions of 6 frames
TWO_HAND = dict(num_envs=4, substeps=2, max_episode_length=5, reset_reaction_nframes=6,
                ball_reaction_force=True, ball_body_contact=True,
                reward_type="return_w_estimate", use_random_ball_target="continuous",
                reset_candidates=2, two_hand_backhand=True, two_hand_iters=4)
CASES = ("dual", "two_hand_left", "two_hand_right")


@pytest.fixture(scope="module")
def parts():
    """The dual's players and the single-player pieces, made once."""
    shared = make_shared()
    return make_players(), shared


def _env(parts, case, **over) -> TennisEnv:
    players, (jspec, feats, jgen, _, tfrozen) = parts
    if case == "dual":
        return build_dual(players, jgen, **dict(DUAL_CASE, **over))[1]
    spec = dataclasses.replace(_port_spec(jspec), righthand=case == "two_hand_right")
    return TennisEnv(TennisConfig(**dict(TWO_HAND, **over)), spec, feats,
                     ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"),
                     pi_low=tfrozen.as_pi_low(), device="cpu")


def _agent(env) -> V2PPPO:
    dual = isinstance(env, DualTennisEnv)
    return V2PPPO(env, V2PConfig(**LEARNER, num_policies=2 if dual else 1,
                                 aux_dof_res_coef=0.01), seed=3, device="cpu")


def _in_backhand(env, state):
    """`state` with the two-hand rows' swing type set to a backhand."""
    mvae = state.mvae
    swing = torch.where(env.two_hand_mask, 2, mvae.swing_type).to(torch.int32)
    return dataclasses.replace(state, mvae=dataclasses.replace(mvae, swing_type=swing))


@pytest.mark.parametrize("case", CASES)
def test_staged_epoch_equals_eager(parts, case, monkeypatch):
    """Two epochs from one state, the env's generator set to one state
    before each pair: metrics, params (stacked over two policies for the
    dual), moments, count, both norms, env state, last obs and lr bit for
    bit; the two-hand fix applied to some rows of both epochs. One capture
    per graph; the staged steps (the IK's autograd backward, the serve and
    hand-off flights inside) and the optimizer step dispatch no op a capture
    refuses."""
    env = _env(parts, case)
    agent = _agent(env)
    masks, ik = [], TH.optimize_two_hand_backhand

    def recorded(rm, rest, mask=None, **kw):
        masks.append(mask.clone())
        return ik(rm, rest, mask=mask, **kw)

    monkeypatch.setattr(TH, "optimize_two_hand_backhand", recorded)
    a, b = _two_states(agent)
    a.env_state, b.env_state = _in_backhand(env, a.env_state), _in_backhand(env, b.env_state)
    for _ in range(2):
        g = env.generator.get_state()
        a, ma = agent._train_epoch_eager(a)
        env.generator.set_state(g)
        b, mb = agent._train_epoch_graphed(b)
        _assert_same(a, ma, b, mb)
        assert float(mb["grad_skip"]) == 0.0
    if case == "dual":
        assert all(v.shape[0] == 2 for v in b.params.values())
    assert len(masks) == 16 and int(torch.stack(masks).sum()) > 0, "the fix never applied"
    st = agent._st
    assert (st.step.captures, st.update.captures) == (1, 1)
    st.row.zero_()
    assert _refused(st.step.body) == []
    st.row.zero_()
    assert _refused(st.update.body) == []


@pytest.mark.parametrize("case", ["dual", "two_hand_right"])
def test_step_draws_are_the_steps_own(parts, case):
    """`step(draws=step_draws())` equals `step(draws=None)` from one state
    of the env's generator, over three steps through a masked reset (the
    dual's serve included), and leaves the generator where the eager step
    leaves it. The dual's draws hold the serve's uniforms and no step-level
    pool sample or jitter; the init rows are drawn lane by lane."""
    env = _env(parts, case, max_episode_length=2)
    state0 = _in_backhand(env, env.reset_all()[0])
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
    dual = case == "dual"
    assert ("serve_u" in draws["reset"]) == dual
    assert ("ball_idx" in draws) == ("near_jitter" in draws) == (not dual)
    m = 4 if dual else 2
    assert draws["reset"]["init_idx"].shape == (m,) and draws["reset"]["init_idx"].dtype == \
        torch.int64
    if dual:
        assert draws["reset"]["serve_u"].shape == (4, 3)
        # lane l's rows are l::2, each lane's drawn in one call
        g0 = env.generator.get_state()
        draws = env.step_draws()
        env.generator.set_state(g0)
        torch.rand((4, 2), generator=env.generator)
        lane0 = torch.randint(0, env._init_per_lane, (2,), generator=env.generator)
        lane1 = torch.randint(0, env._init_per_lane, (2,), generator=env.generator)
        assert torch.equal(draws["reset"]["init_idx"][0::2], lane0)
        assert torch.equal(draws["reset"]["init_idx"][1::2], lane1)


def test_ik_and_fk_hold_no_refused_op(parts):
    """The SMPL FK of the IK (forward) and the whole IK (forward, autograd
    backward, Adam, mask) dispatch no op a capture refuses once their
    constants exist (the first call makes them, as a capture's warm-up
    does); the check sees the Python-list index the IK used to take."""
    gen = torch.Generator().manual_seed(0)
    rm = R.angle_axis_to_rotmat(torch.randn(6 * 24, 3, generator=gen) * 0.3).reshape(6, 24, 3, 3)
    rest = torch.randn(6, 24, 3, generator=gen) * 0.2
    mask = torch.tensor([True, False, True, True, False, True])
    for rh in (True, False):
        TH.optimize_two_hand_backhand(rm, rest, righthand=rh, iters=2, mask=mask)
        assert _refused(lambda: S.batch_rigid_transform(rm, rest)) == []
        assert _refused(lambda: TH.optimize_two_hand_backhand(rm, rest, righthand=rh, iters=2,
                                                              mask=mask)) == []
    assert "host data" in _refused(lambda: rm[:, [20, 18, 16, 13]])


def test_rest_pose_is_made_once_per_model(parts):
    """The IK's rest pose is one tensor per model: the same object on every
    read, a new one for a copy stepping another model (`with_model`, as the
    randomized epochs make), each equal to the tree's accumulated
    offsets."""
    env = _env(parts, "two_hand_left")
    rest = env.rest_joints_smpl
    assert env.rest_joints_smpl is rest
    model = dataclasses.replace(env.model, joint_pos=env.model.joint_pos * 1.1)
    other = env.with_model(model)
    assert other.rest_joints_smpl is not rest and env.rest_joints_smpl is rest
    for e in (env, other):
        off = e.model.joint_pos
        g = [torch.zeros_like(off[:, 0])]
        for j in range(1, 24):
            g.append(g[int(e.model.parents[j])] + off[:, j])
        want = torch.stack(g, dim=1)[:, torch.as_tensor(S.MUJOCO_2_SMPL, dtype=torch.long)]
        assert torch.equal(e.rest_joints_smpl, want)
