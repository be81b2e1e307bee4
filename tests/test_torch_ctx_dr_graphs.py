"""The context-IK and domain-randomized epochs replayed from CUDA graphs
(`ImitationPPO._train_epoch_graphed`, `V2PPPO._train_epoch_graphed`,
``vid2player3d_torch/utils/graphs.py``), on the CPU, where each
`StaticGraph` runs its step on the static tensors as it is (the path the
card captures and replays), and the capture-clean 3×3 orthogonal fit of the
context IK (``vid2player3d_torch/core/ik.py`` `_kabsch`).

- `_kabsch` against the JAX package's SVD form in f32: random, near-
  reflection, rank-2 and all-zero systems at 1e-5. Of rank 1 no rotation is
  unique: the JAX package's own pick moves by O(0.1) under a one-ulp change
  of one input, and both picks reach the optimum.
- The staged epochs against the eager ones (`_train_epoch_eager`) from one
  state and one seed of each generator, bit for bit over two epochs:
  `amass_im_corrupt` (the reset's corruption, the context IK in every step
  and, with its gradient, in every optimizer step; K1's plain version over
  24 leaves), `amass_im_dr` and `federer_train_stage_1_dr` from epoch 300
  (the linear noise at 0.4 of its strength and growing, the mass and gain
  or ball constants drawn anew each epoch), so a stale schedule or stale
  constants would show. Each epoch's `last_env` keeps its own constants.
- The staged step and update bodies dispatch no op a capture refuses, and
  neither does making an epoch's randomized model or the tennis step graph's
  key (a model made anew shares its tree's index tensors).

Everything here is the port's own at test widths (no JAX epoch).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dispatch import _refused
from vid2player3d_tpu.core import ik as JIK
from vid2player3d_torch.core import ik as IK
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImEnv, TennisEnv
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, V2PConfig, V2PPPO
from vid2player3d_torch.parallel import mesh as PM
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import TennisBallGenerator

torch.set_num_threads(1)

EPOCH = 300          # schedule step 300 · horizon: the linear noise at 0.4 of its strength
IM = dict(horizon=4, minibatch_size=8, mini_epochs=2, fused_optimizer="on")
TENNIS = dict(horizon=4, minibatch_size=8, mini_epochs=2, actor_units=(64, 32),
              critic_units=(64, 32), compute_dtype="f32")


# -- the orthogonal fit -------------------------------------------------------

def _systems(kind, B=64, seed=0):
    """(rest, target) column sets (B, 3, 3) of one kind of Procrustes system."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, 3, 3)).astype(np.float32)
    R = np.linalg.qr(rng.standard_normal((B, 3, 3)))[0]
    R *= np.sign(np.linalg.det(R))[:, None, None]           # proper rotations
    if kind == "random":
        T = rng.standard_normal((B, 3, 3))
    elif kind == "near_reflection":
        # a reflected copy: det S < 0, the fit's sign flip decides
        T = R @ np.diag([1.0, 1.0, -1.0]) @ A + 0.3 * rng.standard_normal((B, 3, 3))
    elif kind == "rank2":
        A[:, :, 2] = 0.0
        T = R @ A + 0.05 * rng.standard_normal((B, 3, 3))
    else:   # all zero
        A[:] = 0.0
        T = np.zeros((B, 3, 3))
    return A, T.astype(np.float32)


def _gap(A, T):
    """(σ₂ + sign(det S)·σ₃) / σ₁ of S = A·Tᵀ: how well the fit is posed."""
    S = A.astype(np.float64) @ np.swapaxes(T, -1, -2).astype(np.float64)
    sv = np.linalg.svd(S, compute_uv=False)
    return (sv[:, 1] + np.sign(np.linalg.det(S)) * sv[:, 2]) / sv[:, 0]


@pytest.mark.parametrize("kind", ["random", "near_reflection", "rank2", "zero"])
def test_kabsch_matches_jax(kind):
    """The fit in Horn's form against the JAX package's SVD form to 1e-5
    (both f32), on systems posed well enough for f32 to pin the rotation
    (σ₂ + sign·σ₃ ≥ 0.05 σ₁; worse-posed ones move both forms alike); every
    result a proper rotation; all-zero systems the identity exactly."""
    A, T = _systems(kind)
    got = IK._kabsch(torch.from_numpy(A), torch.from_numpy(T)).numpy()
    want = np.asarray(JIK._kabsch(jnp.asarray(A), jnp.asarray(T)))
    if kind == "zero":
        np.testing.assert_array_equal(got, np.broadcast_to(np.eye(3), got.shape))
        np.testing.assert_array_equal(want, got)
        return
    keep = _gap(A, T) >= 0.05
    assert keep.sum() >= len(keep) // 2
    if kind == "near_reflection":
        S = A @ np.swapaxes(T, -1, -2)
        assert (np.linalg.det(S[keep]) < 0).mean() > 0.5
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-5)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_kabsch_rank_one_reaches_the_optimum():
    """Three equal target columns (a context frame whose three children of
    the pelvis or of the chest are all dropped) make S rank 1: every
    rotation taking its left singular vector to its right one is optimal.
    The JAX package's SVD picks by the rounding of S (a one-ulp change of
    one input moves its rotation by more than 0.1); the port's pick is a
    proper rotation that reaches the same objective tr(R·S) to 1e-6."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 3, 3)).astype(np.float32)
    T = np.repeat(rng.standard_normal((6, 3, 1)).astype(np.float32), 3, axis=2)
    A2 = A.copy()
    A2[:, 0, 0] = np.nextafter(A2[:, 0, 0], np.float32(10.0))
    w1, w2 = (np.asarray(JIK._kabsch(jnp.asarray(a), jnp.asarray(T))) for a in (A, A2))
    assert np.abs(w1 - w2).max() > 0.1
    got = IK._kabsch(torch.from_numpy(A), torch.from_numpy(T)).numpy()
    S = A.astype(np.float64) @ np.swapaxes(T, -1, -2).astype(np.float64)
    best = np.linalg.svd(S, compute_uv=False)[:, 0]

    def objective(R):
        return np.einsum("bij,bji->b", R.astype(np.float64), S)

    np.testing.assert_allclose(objective(got), best, rtol=1e-6)
    np.testing.assert_allclose(objective(w1), best, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_context_ik_dispatches_no_refused_op():
    """The context IK at a rollout's shape (the pelvis and chest fits
    included) dispatches no op a capture refuses; the check sees the
    syncing solvers."""
    B = 8
    pos = torch.randn(B, 24, 3)
    rest = torch.randn(B, 24, 3) * 0.2
    IK.perform_context_ik(pos, rest, torch.zeros(B, 46), torch.zeros(B, 30))   # the tables
    assert _refused(lambda: IK.perform_context_ik(pos, rest, torch.zeros(B, 46),
                                                  torch.zeros(B, 30))) == []
    S = torch.randn(B, 3, 3)
    assert _refused(lambda: torch.linalg.svd(S)) != []
    assert _refused(lambda: torch.linalg.eigh(S @ S.transpose(-1, -2))) != []
    assert _refused(lambda: torch.linalg.eig(S)) != []


# -- the staged epochs ----------------------------------------------------------

def _im_agent(name):
    env_cfg, ppo_cfg = preset(name, num_envs=4)
    env = HumanoidImEnv(env_cfg, make_synthetic_motion_lib(num_motions=2, T=60, seed=0,
                                                           device="cpu"), device="cpu")
    return ImitationPPO(env, dataclasses.replace(ppo_cfg, **IM), seed=7, device="cpu")


def _tennis_agent():
    spec = P.make_random_spec(0, hidden=64, experts=3, device="cpu")
    feats = (np.random.default_rng(0).standard_normal((64, 288)) * 0.05).astype(np.float32)
    feats[:, 2] = 0.95
    env_cfg, v2p_cfg = preset("federer_train_stage_1_dr", num_envs=4, reset_candidates=2,
                              substeps=2, max_episode_length=5)
    env = TennisEnv(env_cfg, spec, feats,
                    ball_generator=TennisBallGenerator(num_candidates=256, device="cpu"),
                    pi_low=FrozenImitator.zeros(device="cpu"), device="cpu")
    return V2PPPO(env, dataclasses.replace(v2p_cfg, **TENNIS), seed=3, device="cpu")


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
    assert torch.equal(a.lr, b.lr) and a.epoch == b.epoch
    if hasattr(a, "env_state"):
        for x, y in zip(PM.tree_leaves(a.env_state), PM.tree_leaves(b.env_state)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert torch.equal(a.last_obs, b.last_obs)


def _two_states(agent):
    """Two train states from one state of the env's generator, at EPOCH."""
    g = agent.env.generator.get_state() if hasattr(agent.env, "generator") else None
    a = agent.init_state()
    if g is not None:
        agent.env.generator.set_state(g)
    b = agent.init_state()
    a.epoch = b.epoch = EPOCH
    return a, b


def _constants(agent, env):
    """The epoch env's randomized constants, copied."""
    dr = agent.env.randomizer
    out = [getattr(env.model, sp.field).clone() for sp in dr.model_specs]
    return out + [torch.as_tensor(getattr(env.ball_params, sp.field[5:])).clone()
                  for sp in dr.ball_specs]


def _epochs(agent):
    """Two eager and two staged epochs from one start, bit for bit; the
    staged agent's statics and each epoch's env constants."""
    a, b = _two_states(agent)
    envs = []
    for _ in range(2):
        gen = getattr(agent.env, "generator", None)
        g = None if gen is None else gen.get_state()
        a, ma = agent._train_epoch_eager(a)
        eager_env = agent.last_env
        if gen is not None:
            gen.set_state(g)
        b, mb = agent._train_epoch_graphed(b)
        _assert_same(a, ma, b, mb)
        envs.append((eager_env, agent.last_env, _constants(agent, agent.last_env)
                     if agent.env.randomizer else []))
        for k, v in mb.items():
            assert bool(torch.isfinite(v)) or k.startswith("racket_ball_dist"), k
    return agent._st, envs


@pytest.mark.parametrize("name", ["amass_im_corrupt", "amass_im_dr", "federer_train_stage_1_dr"])
def test_staged_epoch_equals_eager(name):
    """Two epochs, staged against eager, bit for bit; one capture per graph.
    Under randomization each epoch's constants are inside the specs' ranges
    of the base, differ from the other epoch's, and the first epoch's
    `last_env` still holds its own after the second (no aliasing of the
    static env); the base env keeps its constants."""
    agent = _tennis_agent() if name.endswith("_dr") and "federer" in name else _im_agent(name)
    base = [t.clone() for t in _constants(agent, agent.env)] if agent.env.randomizer else []
    st, envs = _epochs(agent)
    assert (st.step.captures, st.update.captures) == (1, 1)
    if name == "amass_im_corrupt":
        assert len(agent.stat_names) == 7 and len(agent.net.state_dict()) == 24
        assert "ctx_conf" in st.traj and float(st.traj["ctx_conf"].min()) < 1.0
        return
    (e0, g0, c0), (e1, g1, c1) = envs
    assert g0 is not g1 and g0 is not st.env and g1 is not st.env
    for x0, x1, b in zip(c0, c1, base):
        assert not torch.equal(x0, x1)
        assert not torch.equal(x0, b) and float((x0 / b).min()) >= 0.85 - 1e-6
        assert float((x0 / b).max()) <= 1.15 + 1e-6
    # the first epoch's env still holds its constants; the base its own
    for x, want in zip(_constants(agent, g0), c0):
        assert torch.equal(x, want)
    for x, want in zip(_constants(agent, agent.env), base):
        assert torch.equal(x, want)
    # the static env holds the last epoch's
    for x, want in zip(_constants(agent, st.env), c1):
        assert torch.equal(x, want)


@pytest.mark.parametrize("name", ["amass_im_corrupt", "amass_im_dr", "federer_train_stage_1_dr"])
def test_staged_bodies_hold_no_refused_op(name):
    """The step body (with the context IK, or with the randomization's
    static noise on the static env) and the update body (with the context
    IK's gradient and K1's plain version) dispatch no op that syncs with the
    host, has a data-dependent shape or makes a tensor from host data."""
    agent = _tennis_agent() if "federer" in name else _im_agent(name)
    ts = agent.init_state()
    ts.epoch = EPOCH
    agent._train_epoch_graphed(ts)
    st = agent._st
    st.row.zero_()
    assert _refused(st.step.body) == []
    st.row.zero_()
    assert _refused(st.update.body) == []


def test_new_models_copy_nothing_from_the_host():
    """An epoch's randomized model and the tennis step graph's key (a walk
    over the model's leaves, which rebuilds the model) make no tensor from
    host data: a model made anew shares its tree's index tensors, which on
    the card would otherwise be copies that sync in every epoch."""
    im = _im_agent("amass_im_dr")
    ts = im.init_state()
    im.epoch_env(ts)                                   # the first build of the tables
    assert _refused(lambda: im.epoch_env(ts)) == []
    assert im.epoch_env(ts).model.topo is im.env.model.topo
    tennis = _tennis_agent()
    tennis.init_state()
    assert _refused(lambda: tennis._step_key(dict(tennis.net.named_parameters()))) == []
