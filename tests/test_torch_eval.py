"""The port's evaluation suite and HTML renderer against the JAX package's:
`eval_tennis` (with `per_env`), `eval_imitation`, `select_best`,
`export_rollout` (single and dual, the dual one with a two-handed lane and
its post-hoc refinement), `export_imitation_rollout`, and `render_html`
byte for byte.

The JAX functions reset from fixed keys (4321, 7, 1234, 11) and jit one
rollout each. The port is fed the draws those keys split into: the reset's
and every step's, replayed as tests/test_torch_tennis_env.py and
tests/test_torch_dual.py replay them (a state's key after a reset is the
sixth split of the reset key, the next step's the first split of the last).
Both start from the same params with the same non-trivial obs normalizer.
All f32 on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dual
from test_torch_dual import (DUAL, build_dual, dual_reset_draws, dual_step_draws,
                             make_players)
from test_torch_tennis_env import build_envs, make_shared, reset_draws, step_draws
from vid2player3d_tpu import eval as JE
from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JImCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JImEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.learn import running_norm as JRN
from vid2player3d_tpu.tennis import ball as JB
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_tpu.vis import render_html as j_render
from vid2player3d_torch import eval as E
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.learn import ImitationPPO, PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.learn import running_norm as RN
from vid2player3d_torch.utils import checkpoint as CK
from vid2player3d_torch.vis import render_html

torch.set_num_threads(1)

N = 4
TENNIS = dict(num_envs=N, substeps=2, max_episode_length=12, reset_reaction_nframes=6,
              reward_type="reach", use_random_ball_target="discrete")
LEARNER = dict(horizon=4, minibatch_size=8, mini_epochs=1, actor_units=(64, 32),
               critic_units=(64, 32), compute_dtype="f32")
EVAL_STEPS, EXPORT_STEPS, DUAL_STEPS = 16, 12, 8
IM = dict(num_envs=N, substeps=2, context_length=8)
IM_ROLLOUTS, IM_MAX_STEPS, IM_EXPORT_STEPS = 2, 16, 12


def _obs_norm(dim, seed):
    """The same non-trivial running normalizer for both packages."""
    rng = np.random.default_rng(seed)
    mean = (rng.standard_normal(dim) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, dim).astype(np.float32)
    return (JRN.RunningNormState(n=jnp.asarray(10.0), mean=jnp.asarray(mean),
                                 var=jnp.asarray(var)),
            RN.RunningNormState(n=torch.tensor(10.0), mean=torch.tensor(mean),
                                var=torch.tensor(var)))


def _agents(jenv, tenv, **learner):
    """(JAX agent, JAX train state, port agent, port train state) from the
    same params and normalizer."""
    jagent = JV2P(jenv, JV2PCfg(**LEARNER, **learner), seed=3)
    jts = jagent.init_state()
    jnorm, tnorm = _obs_norm(jenv.obs_dim, 1)
    jts = dataclasses.replace(jts, obs_norm=jnorm)
    tagent = V2PPPO(tenv, V2PConfig(**LEARNER, **learner), seed=3, device="cpu")
    tts = tagent.init_state(params=CK.params_from_jax(_flatten(jts.params)))
    tts.obs_norm = tnorm
    return jagent, jts, tagent, tts


def _tennis_draws(jenv, seed, steps, dual=False):
    """The reset draws of `PRNGKey(seed)` and each step's from the state's
    key chain."""
    key = jax.random.PRNGKey(seed)
    out = {"reset": (dual_reset_draws if dual else reset_draws)(jenv, key, jenv.cfg.num_envs),
           "steps": []}
    k = jax.random.split(key, 6)[5]
    for _ in range(steps):
        out["steps"].append((dual_step_draws if dual else step_draws)(jenv, k))
        k = jax.random.split(k, 6)[0]
    return out


@pytest.fixture(scope="module")
def tennis():
    jenv, tenv = build_envs(make_shared(), **TENNIS)
    return (jenv,) + _agents(jenv, tenv)


@pytest.fixture(scope="module")
def tennis_eval(tennis):
    jenv, jagent, jts, tagent, tts = tennis
    want = JE.eval_tennis(jagent, num_steps=EVAL_STEPS, per_env=True, ts=jts)
    got = E.eval_tennis(tagent, num_steps=EVAL_STEPS, per_env=True, ts=tts,
                        draws=_tennis_draws(jenv, 4321, EVAL_STEPS))
    return want, got


def test_eval_tennis_matches(tennis_eval):
    """The report and the per-env stats of 16 steps (a cycle ends in every
    env, the episodes end at step 12 and reset): the cycle counts exact, the
    rates, the reward and the root distance within 1e-5."""
    (w_rep, w_pe), (g_rep, g_pe) = tennis_eval
    assert set(g_rep) == set(w_rep) and set(g_pe) == set(w_pe)
    assert g_rep["cycles"] == w_rep["cycles"] and w_rep["cycles"] >= N
    for k, v in w_rep.items():
        if v is None:
            assert g_rep[k] is None, k
        else:
            np.testing.assert_allclose(g_rep[k], v, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(g_pe["cycles"], w_pe["cycles"])
    for k, v in w_pe.items():
        np.testing.assert_allclose(g_pe[k], np.asarray(v), atol=1e-5, err_msg=k)


def test_staged_eval_tennis_matches(tennis, tennis_eval, monkeypatch):
    """The staged rollout (each step the body a CUDA graph replays on the
    card, here run on the CPU; tests/test_torch_eval_graphs.py holds it to
    the eager one bit for bit) fed the same JAX draws: JAX's report and
    per-env stats at `test_eval_tennis_matches`'s tolerances."""
    jenv, _, _, tagent, tts = tennis
    (w_rep, w_pe), _ = tennis_eval
    monkeypatch.setattr(V2PPPO, "graphed", property(lambda self: True))
    g_rep, g_pe = E.eval_tennis(tagent, num_steps=EVAL_STEPS, per_env=True, ts=tts,
                                draws=_tennis_draws(jenv, 4321, EVAL_STEPS))
    assert tagent._eval_st[E._tennis_eval_record].step.captures == 1
    assert set(g_rep) == set(w_rep) and g_rep["cycles"] == w_rep["cycles"]
    for k, v in w_rep.items():
        if v is None:
            assert g_rep[k] is None, k
        else:
            np.testing.assert_allclose(g_rep[k], v, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(g_pe["cycles"], w_pe["cycles"])
    for k, v in w_pe.items():
        np.testing.assert_allclose(g_pe[k], np.asarray(v), atol=1e-5, err_msg=k)


def test_evaluate_dispatches(tennis):
    """`evaluate` runs `eval_tennis` for a V2PPPO (64 steps per epoch) and
    rejects other agents."""
    jenv, _, _, tagent, tts = tennis
    rep = E.evaluate(tagent, num_epochs=1, steps_per_epoch=4, ts=tts,
                     draws=_tennis_draws(jenv, 4321, 4))
    assert set(rep) == {"cycles", "hit_rate", "bounce_in_rate", "bounce_pos_error",
                        "fh_ratio", "reward_mean"}
    with pytest.raises(TypeError):
        E.evaluate(object())


def test_select_best_matches():
    """`select_best` against the JAX function: the JAX test's cases and 50
    seeded random stat sets, with ties, exactly."""
    cases = [dict(bounce_in_rate=np.array([1.0, 0.5, 1.0, 0.99]),
                  fh_ratio=np.array([0.5, 0.1, 0.7, 0.3]), cycles=np.array([3, 3, 3, 3]),
                  distance=np.array([1.0, 9.0, 5.0, 4.0]))]
    cases.append(dict(cases[0], bounce_in_rate=np.zeros(4)))
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        cases.append(dict(bounce_in_rate=rng.choice([0.5, 0.96, 1.0], n),
                          fh_ratio=rng.choice([0.2, 0.6, 0.9], n),
                          cycles=rng.integers(0, 3, n).astype(np.float64),
                          distance=rng.choice([0.0, 1.0, 2.5, 7.0], n)))
    for st in cases:
        for num in (1, 2, 4):
            np.testing.assert_array_equal(E.select_best(st, num=num),
                                          np.asarray(JE.select_best(st, num=num)))


EXACT = ("swing", "done", "contact", "bounce_in", "wrist_id")


def _compare_exports(got_path, want_path, atol):
    got, want = dict(np.load(got_path)), dict(np.load(want_path))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)
    return got, want


def test_export_rollout_and_render_match(tennis, tmp_path):
    """`export_rollout` (12 steps from key 7): every array, the integer and
    boolean records exact, the kinematics within 1e-4 (12 chaotic physics
    steps, as tests/test_torch_tennis_env.py holds six). The port's HTML of
    the JAX npz (two chosen envs) is the JAX renderer's, byte for byte."""
    jenv, jagent, jts, tagent, tts = tennis
    want = JE.export_rollout(jagent, str(tmp_path / "j.npz"), num_steps=EXPORT_STEPS, ts=jts)
    got = E.export_rollout(tagent, str(tmp_path / "t.npz"), num_steps=EXPORT_STEPS, ts=tts,
                           draws=_tennis_draws(jenv, 7, EXPORT_STEPS))
    _compare_exports(got, want, 1e-4)
    for kw in ({}, {"env_ids": [0, 2]}, {"env_ids": np.array([3, 1]), "max_frames": 5}):
        j_render(want, str(tmp_path / "j.html"), **kw)
        render_html(want, str(tmp_path / "t.html"), **kw)
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes(), kw


def test_dual_export_and_render_match(tmp_path, monkeypatch):
    """The dual rally as tests/test_torch_dual.py builds it (lane 0 a
    left-handed nadal, lane 1 a right-handed federer; 6 substeps), here with
    the two-hand backhand on both lanes so that the post-hoc refinement (50
    iterations, one pass per racket hand) meets a backhand frame within 8
    steps: `export_rollout` from key 7 within 1e-4 (8.4e-6 measured in the
    refined rotations); the per-lane wrist ids; the dual HTML byte for
    byte."""
    monkeypatch.setattr(test_torch_dual, "LANES_TWO_HAND", (True, True))
    players = make_players()
    jgen = JB.TennisBallGenerator(num_candidates=256, seed=0, backend="jax")
    jenv, tenv = build_dual(players, jgen, **DUAL)
    jagent, jts, tagent, tts = _agents(jenv, tenv, num_policies=2)
    want = JE.export_rollout(jagent, str(tmp_path / "j.npz"), num_steps=DUAL_STEPS, ts=jts)
    got = E.export_rollout(tagent, str(tmp_path / "t.npz"), num_steps=DUAL_STEPS, ts=tts,
                           draws=_tennis_draws(jenv, 7, DUAL_STEPS, dual=True))
    g, w = _compare_exports(got, want, 1e-4)
    refined = (g["swing"] == 2) & (g["phase"] > 2.0) & (g["phase"] < 5.0)
    assert refined.any()
    # the left-handed lane's wrist differs from the right-handed lane's
    assert len(set(g["wrist_id"][0::2])) == len(set(g["wrist_id"][1::2])) == 1
    assert g["wrist_id"][0] != g["wrist_id"][1]
    j_render(want, str(tmp_path / "j.html"), dual=True)
    render_html(want, str(tmp_path / "t.html"), dual=True)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


# -- imitation --------------------------------------------------------------------

@pytest.fixture(scope="module")
def imitation():
    jenv = JImEnv(JImCfg(**IM), j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, JPPOCfg(horizon=4, minibatch_size=8, mini_epochs=1), seed=7)
    jts = jagent.init_state()
    jnorm, tnorm = _obs_norm(734, 2)
    jts = dataclasses.replace(jts, obs_norm=jnorm)
    tenv = HumanoidImEnv(HumanoidImConfig(**IM),
                         t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    tagent = ImitationPPO(tenv, PPOConfig(horizon=4, minibatch_size=8, mini_epochs=1), seed=7,
                          device="cpu")
    tts = tagent.init_state(CK.params_from_jax(_flatten(jts.params)))
    tts.obs_norm = tnorm
    return jenv, jagent, jts, tagent, tts


def _reset_times(jenv, keys):
    """The reset times `HumanoidImEnv.reset_all(k)` draws, for each key."""
    trunc = jenv.cfg.context_length * jenv.cfg.control_dt
    return {"motion_times": [np.asarray(JML.sample_time(
        jenv.lib, jax.random.split(k)[0], jenv.motion_ids, truncate_time=trunc)) for k in keys]}


def test_eval_imitation_matches(imitation):
    """`eval_imitation` with two rollouts of two 8-step context segments
    each (the context rebuilt between them), fed the reset times of the JAX
    keys. The counts (alive ratio, episode length, success rate) exact. The
    stiff stable-PD physics amplifies the policy's float differences
    (ROADMAP queue 3, golden rollout): the per-step means (reward, MPJPE,
    sub-rewards) reach 1.2e-5 and the 16-step episode reward 1.1e-4 of
    11.0 (measured), so they are held to 3e-5 plus 3e-5 relative."""
    jenv, jagent, jts, tagent, tts = imitation
    want = JE.eval_imitation(jagent, num_rollouts=IM_ROLLOUTS, ts=jts, max_steps=IM_MAX_STEPS)
    keys = jax.random.split(jax.random.PRNGKey(1234), IM_ROLLOUTS)
    got = E.eval_imitation(tagent, num_rollouts=IM_ROLLOUTS, ts=tts, max_steps=IM_MAX_STEPS,
                           draws=_reset_times(jenv, keys))
    assert set(got) == set(want)
    for k in ("alive_ratio", "episode_len", "success_rate"):
        assert got[k] == want[k], k
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=3e-5, rtol=3e-5, err_msg=k)


def test_export_imitation_rollout_and_render_match(imitation, tmp_path):
    """`export_imitation_rollout` (12 steps over two segments from key 11):
    `done` exact, the reference (ghost) body positions within 1e-5 (5e-7
    measured). The simulated body positions drift with the stiff PD as in
    `test_eval_imitation_matches`: 1.2e-4 after one step, 3.1e-3 at most
    over the 12 (measured), held to 8e-3. The ghost HTML byte for byte."""
    jenv, jagent, jts, tagent, tts = imitation
    want = JE.export_imitation_rollout(jagent, str(tmp_path / "j.npz"),
                                       num_steps=IM_EXPORT_STEPS, ts=jts)
    got = E.export_imitation_rollout(tagent, str(tmp_path / "t.npz"),
                                     num_steps=IM_EXPORT_STEPS, ts=tts,
                                     draws=_reset_times(jenv, [jax.random.PRNGKey(11)]))
    g, w = _compare_exports(got, want, 8e-3)
    assert g["body_pos"].shape == (IM_EXPORT_STEPS, N, 24, 3)
    np.testing.assert_allclose(g["ref_body_pos"], w["ref_body_pos"], atol=1e-5)
    np.testing.assert_allclose(g["body_radius"], w["body_radius"], atol=1e-7)
    j_render(want, str(tmp_path / "j.html"), env_ids=[0, 1])
    render_html(want, str(tmp_path / "t.html"), env_ids=[0, 1])
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    with pytest.raises(TypeError):
        E.export_imitation_rollout(object(), str(tmp_path / "x.npz"))


def test_render_html_synthetic_matches(tmp_path):
    """Both renderers on the JAX test's paired-lane dict and a seeded
    single-player dict with every optional key: byte for byte."""
    T, n = 6, 4
    body = np.zeros((T, n, 24, 3), np.float32)
    body[:, 1, :, 0] = 2.0
    body[:, 1, :, 1] = -13.0
    rng = np.random.default_rng(5)
    rolls = [({"body_pos": body, "ball_pos": np.zeros((T, n, 3), np.float32),
               "racket_pos": np.zeros((T, n, 3), np.float32)}, {"dual": True}),
             ({"body_pos": rng.standard_normal((T, n, 24, 3)).astype(np.float32),
               "ref_body_pos": rng.standard_normal((T, n, 24, 3)).astype(np.float32),
               "ball_pos": rng.standard_normal((T, n, 3)).astype(np.float32),
               "racket_pos": rng.standard_normal((T, n, 3)).astype(np.float32),
               "body_radius": rng.uniform(0.02, 0.1, 24).astype(np.float32),
               "wrist_id": np.int32(21)}, {"env_ids": [1, 3]})]
    for roll, kw in rolls:
        j_render(roll, str(tmp_path / "j.html"), **kw)
        render_html(roll, str(tmp_path / "t.html"), **kw)
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    assert os.path.getsize(tmp_path / "t.html") < 8_000_000
