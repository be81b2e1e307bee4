"""The JAX package's learning checks, run on the port.

The five multi-epoch learning tests of the JAX package's slow tier
(`test_ppo.py::test_reward_improves`,
`test_pi_low.py::test_full_pipeline_train_then_embed`,
`::test_trained_pi_low_beats_pure_pd_tracking`,
`::test_trained_pi_low_stable_in_tennis`,
`test_context_ik.py::test_train_epoch_aux_losses_finite_and_learning`), each
at the JAX test's sizes, seeds, hyperparameters, epoch counts and thresholds
on `vid2player3d_torch`. The JAX tests reset from fixed keys; here the
resets draw from torch generators seeded with the same integers. Each test
runs on two devices: `cpu` (marked `slow`, as its JAX counterpart) and
`cuda` (marked `gpu`; skips without a card), where the learner replays its
epochs from CUDA graphs. Neither imports JAX, so on a machine with the card
and no JAX:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_learning.py

and on the CPU:

    python -m pytest -o addopts="" -m slow --runslow tests/test_torch_learning.py

Besides, in the fast tier, `test_epochs_match_jax` holds four epochs of the
port against the JAX learner on the CPU, fed the JAX learner's draws every
epoch, under the linear and the adaptive lr schedules (JAX imported inside
the test).
"""

import os

import numpy as np
import pytest
import torch

from vid2player3d_torch.data import motion_lib as ML
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv, TennisConfig, TennisEnv
from vid2player3d_torch.envs.corrupt import TransformSpecs
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, PPOConfig
from vid2player3d_torch.physics import engine
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import TennisBallGenerator

torch.set_num_threads(1)

DEVICES = [pytest.param("cpu", marks=pytest.mark.slow, id="cpu"),
           pytest.param("cuda", marks=pytest.mark.gpu, id="cuda")]


@pytest.fixture(params=DEVICES)
def dev(request):
    """The device of a learning test; the `cuda` case skips without a card
    (decided here, never at collection)."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0) if request.param == "cuda" else torch.device("cpu")


def _train(agent, ts, epochs):
    """`epochs` epochs; the metrics of each as floats. On the card the
    learner must replay them from its graphs, captured in the first."""
    rows = []
    for _ in range(epochs):
        ts, m = agent.train_epoch(ts)
        rows.append({k: float(v) for k, v in m.items()})
    assert agent.graphed == (agent.device.type == "cuda")
    if agent.graphed:
        assert (agent._st.step.captures, agent._st.update.captures) == (1, 1)
    return ts, rows


def _tennis_env(dev, pi_low=None, num_envs=4, seed=2):
    """`test_pi_low.py`'s tennis env; its resets draw from a generator
    seeded `seed` (the JAX test's reset key)."""
    spec = P.make_random_spec(0, hidden=32, experts=2, device=dev)
    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((8, P.FRAME_SIZE)) * 0.05).astype(np.float32)
    feats[:, 2] = 0.95
    cfg = TennisConfig(num_envs=num_envs, substeps=2, max_episode_length=50,
                       reset_reaction_nframes=12)
    gen = TennisBallGenerator(num_candidates=256, seed=0, device=dev)
    return TennisEnv(cfg, spec, feats, ball_generator=gen, pi_low=pi_low, seed=seed, device=dev)


@torch.no_grad()
def _rollout(env, nsteps):
    state, _ = env.reset_all()
    act = torch.zeros(env.cfg.num_envs, env.num_actions, device=env.device)
    for _ in range(nsteps):
        state, out = env.step(state, act)
    return state, out


def _finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


def test_reward_improves(dev):
    """`test_ppo.py::test_reward_improves`: 30 epochs of PPO on the tiny
    synthetic imitation task (16 envs, adaptive lr 2e-5): the critic
    converges, survival and the tracking reward do not fall below the
    PD-parity start."""
    lib = make_synthetic_motion_lib(num_motions=2, T=90, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=16, substeps=2), lib, rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=16, minibatch_size=64, mini_epochs=2,
                                        learning_rate=2e-5, lr_schedule="adaptive"),
                         seed=7, device=dev)
    _, rows = _train(agent, agent.init_state(), 30)
    rewards, alive, c_loss = ([r[k] for r in rows] for k in ("reward_mean", "alive_ratio",
                                                              "c_loss"))
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert np.mean(c_loss[-5:]) < 0.5 * np.mean(c_loss[:5]), f"c_loss: {c_loss}"
    assert np.mean(alive[-5:]) > np.mean(alive[:5]) - 0.05, f"alive: {alive}"
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]) - 0.02, f"rew: {rewards}"


def test_full_pipeline_train_then_embed(dev, tmp_path):
    """`test_pi_low.py::test_full_pipeline_train_then_embed`: one amass_im-
    style epoch -> checkpoint -> the tennis env with the frozen policy: it
    steps finite, and the trained policy moves the physics away from the PD
    fallback's."""
    lib = make_synthetic_motion_lib(num_motions=2, T=60, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=8, substeps=2), lib, rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=16, mini_epochs=1,
                                        learning_rate=1e-3), seed=3, device=dev)
    ts, rows = _train(agent, agent.init_state(), 1)
    assert np.isfinite(rows[0]["a_loss"])
    path = os.path.join(tmp_path, "im.npz")
    agent.save_checkpoint(path, ts)

    frozen = FrozenImitator.from_checkpoint(path, device=dev)
    state, out = _rollout(_tennis_env(dev, frozen.as_pi_low()), nsteps=6)
    assert _finite(out.obs, state.sim.root_pos)
    s_pd, _ = _rollout(_tennis_env(dev), nsteps=6)
    # a trained (non-zero) policy must steer the physics differently
    assert not torch.allclose(s_pd.sim.root_pos, state.sim.root_pos, atol=1e-4)


@torch.no_grad()
def _tracking_error(agent, ts, policy: bool, seed: int = 7, steps: int = 16) -> float:
    """Mean body-position error (m) over the alive envs of `steps`
    deterministic steps from one fixed reset: the policy's mean action, or
    pure PD of the reference dofs with zero residuals (the tennis env's
    `pi_low=None` fallback)."""
    env = agent.env
    n = env.cfg.num_envs
    state, raw_obs, ctx = env.reset_all(generator=torch.Generator(env.device).manual_seed(seed))
    errs = []
    for t in range(steps):
        if policy:
            act = agent._forward(ts.params, ts.obs_norm, raw_obs, ctx["feat"], t)[2]
        else:
            c_dof = agent._ctx_frame(ctx["feat"], t)[2]
            act = torch.cat([c_dof, torch.zeros(n, 6, device=env.device)], dim=-1)
        state, out = env.step(state, act)
        raw_obs = out.obs
        tar = ML.get_motion_state(env.lib, env.motion_ids, state.motion_times,
                                  adjust_height=True)
        bp = engine.fk_world(env.model, state.sim)[0]
        err = torch.linalg.norm(tar["rb_pos"] - bp, dim=-1).mean(-1)
        errs.append(torch.where(state.reset_buf == 0, err, torch.nan))
    return float(np.nanmean(torch.stack(errs).cpu().numpy()))


def test_trained_pi_low_beats_pure_pd_tracking(dev, tmp_path):
    """`test_pi_low.py::test_trained_pi_low_beats_pure_pd_tracking`: 64
    envs, constant lr 1e-4, the tracking error every 5 epochs over 25. The
    small-init residual heads start the policy at PD parity; the error must
    fall over training and end below pure PD's. The trained checkpoint goes
    through `FrozenImitator`, which must give the learner's mean action."""
    lib = make_synthetic_motion_lib(num_motions=4, T=90, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=64, substeps=2), lib, rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=16, minibatch_size=256, mini_epochs=4,
                                        learning_rate=1e-4, lr_schedule="constant"),
                         seed=3, device=dev)
    ts = agent.init_state()
    curve = [_tracking_error(agent, ts, True)]
    for _ in range(5):
        ts, _ = _train(agent, ts, 5)
        curve.append(_tracking_error(agent, ts, True))
    err_pd = _tracking_error(agent, ts, False)

    path = os.path.join(tmp_path, "im.npz")
    agent.save_checkpoint(path, ts)
    frozen = FrozenImitator.from_checkpoint(path, device=dev)
    state, raw_obs, ctx = env.reset_all(generator=torch.Generator(dev).manual_seed(7))
    with torch.no_grad():
        io, _, mu, _, c_dof = agent._forward(ts.params, ts.obs_norm, raw_obs, ctx["feat"], 0)
        mu_frozen = frozen(io)
    mu_frozen = torch.cat([mu_frozen[:, :69] + c_dof, mu_frozen[:, 69:]], dim=-1)
    # f32 on the CPU; on the card the learner's trunk computes in bf16 (2.1e-4
    # measured), the frozen net in f32
    torch.testing.assert_close(mu_frozen, mu, atol=1e-6 if dev.type == "cpu" else 2e-3, rtol=0)

    err_policy = curve[-1]
    assert all(np.isfinite(curve)) and np.isfinite(err_pd)
    assert err_policy < curve[0] - 0.005, f"no learning: {curve}"
    assert curve[-1] <= min(curve[:2]), f"curve not improving: {curve}"
    assert err_policy < err_pd, (err_policy, err_pd, curve)


def test_trained_pi_low_stable_in_tennis(dev, tmp_path):
    """`test_pi_low.py::test_trained_pi_low_stable_in_tennis`: 5 epochs at
    lr 3e-4 (32 envs), then the trained policy embedded in the tennis env
    (4 envs) steps 20 times, finite."""
    lib = make_synthetic_motion_lib(num_motions=4, T=90, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=32, substeps=2), lib, rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=16, minibatch_size=128, mini_epochs=2,
                                        learning_rate=3e-4), seed=3, device=dev)
    ts, _ = _train(agent, agent.init_state(), 5)
    path = os.path.join(tmp_path, "im.npz")
    agent.save_checkpoint(path, ts)
    pi_low = FrozenImitator.from_checkpoint(path, device=dev).as_pi_low()
    state, out = _rollout(_tennis_env(dev, pi_low, num_envs=4, seed=7), nsteps=20)
    assert _finite(out.obs, state.sim.root_pos)


def test_train_epoch_aux_losses_finite_and_learning(dev):
    """`test_context_ik.py::test_train_epoch_aux_losses_finite_and_learning`:
    amass_im-style epochs under context corruption through the context IK
    (8 envs, lr 3e-4): finite auxiliary losses, and after 6 more epochs the
    dof loss at most 1.5x the first epoch's."""
    specs = TransformSpecs(noisy_joints_prob=0.5, noisy_joints_noise_std=0.02,
                           noisy_joints_conf_std=0.02, noisy_joints_min_conf=0.1,
                           mask_random_joints_prob=0.05)
    lib = make_synthetic_motion_lib(num_motions=2, T=60, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=8, substeps=2, transform_specs=specs), lib,
                        rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=16, mini_epochs=1,
                                        learning_rate=3e-4, use_context_ik=True),
                         seed=3, device=dev)
    ts, rows = _train(agent, agent.init_state(), 7)
    m0, m = rows[0], rows[-1]
    assert np.isfinite(m0["aux_dof_loss"]) and np.isfinite(m0["aux_pos_loss"])
    assert m0["aux_dof_loss"] > 0.0
    assert np.isfinite(m["a_loss"])
    assert m["aux_dof_loss"] <= m0["aux_dof_loss"] * 1.5


# -- four epochs against the JAX learner (CPU, fast tier) --------------------------

N, T, MB, MINI_EPOCHS, SEED, LR, EPOCHS = 4, 4, 8, 2, 7, 2e-5, 4
# test_torch_epoch.py's bounds: the metrics (1e-5 unless listed, plus 1e-4
# relative), the params 2·lr per optimizer step
METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5,
               "clip_frac": 1e-6, "lr": 0.0}
# the obs norm's mean: the epoch's obs differ by up to ~1e-3 in the velocity
# entries (test_torch_env.py), their mean by up to 6e-5 already in the first
# epoch, from the same params (measured)
OBS_MEAN_ATOL = 1e-4
# linear: the lr decays over the four epochs (test_ppo.py's schedule);
# adaptive: the controller's threshold keeps the kl near test_torch_epoch.py's
# (~0.003, where its kl bound was set) while the lr moves up and down. At the
# default 0.008 it drives the kl to 0.04 at lr ~1e-4, where one epoch from the
# same state already differs by 1.4e-5 between the frameworks (measured).
SCHEDULES = {"linear": dict(lr_schedule="linear", lr_decay_epochs=4, lr_min_frac=0.1),
             "adaptive": dict(lr_schedule="adaptive", kl_threshold=0.002)}


def _close(got, want, atol, what):
    """|got - want| <= atol + 1e-4·|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= atol + 1e-4 * np.abs(want)), (what, float(err.max()))


@pytest.fixture(scope="module")
def envs():
    """The JAX env and the port's (the same motions per env), built once
    for both schedules."""
    from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
    from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
    from vid2player3d_tpu.envs import HumanoidImEnv as JEnv

    jenv = JEnv(JEnvCfg(num_envs=N, substeps=2), j_make_lib(num_motions=2, T=60, fps=30.0,
                                                            seed=0), rng=0)
    tenv = HumanoidImEnv(HumanoidImConfig(num_envs=N, substeps=2),
                         make_synthetic_motion_lib(num_motions=2, T=60, fps=30.0, seed=0,
                                                   device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_epochs_match_jax(envs, schedule):
    """Four epochs at 4 envs from the JAX learner's initial params, each fed
    the JAX epoch's draws (its key splits replayed): after every epoch the
    lr, the epoch counter, both running norms (count, mean, var) and the
    metrics match the JAX learner's at test_torch_epoch.py's bounds (the obs
    norm's mean at `OBS_MEAN_ATOL`), the params within twice the sum of the
    optimizer steps' lr so far, and the Adam count is exact. This is what a value frozen in the graphed path's statics (the
    lr, the count, the schedule, the norms) would break from the second
    epoch on; the graphed epoch is held to this eager one bit for bit
    (tests/test_torch_graphs.py)."""
    from test_torch_epoch import _draws
    from vid2player3d_tpu.learn import ImitationPPO as JPPO
    from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
    from vid2player3d_tpu.utils.checkpoint import _flatten
    from vid2player3d_torch.utils import checkpoint as CK

    kw = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, learning_rate=LR,
              fused_optimizer="on", **SCHEDULES[schedule])
    jenv, tenv = envs
    jagent = JPPO(jenv, JPPOCfg(**kw), seed=SEED)
    tagent = ImitationPPO(tenv, PPOConfig(**kw), seed=SEED, device="cpu")
    jts = jagent.init_state()
    tts = tagent.init_state(CK.params_from_jax(_flatten(jts.params)))
    steps = MINI_EPOCHS * (N * T // MB)
    # the lr each optimizer step took (every step hands it to `_adapt_lr`)
    used, adapt = [], tagent._adapt_lr
    tagent._adapt_lr = lambda lr, kl: used.append(float(lr)) or adapt(lr, kl)
    lrs = []
    for e in range(1, EPOCHS + 1):
        draws = _draws(jagent, jts)
        jts, jm = jagent.train_epoch(jts)
        tts, tm = tagent.train_epoch(tts, draws=draws)
        jm = {k: float(v) for k, v in jm.items()}
        tm = {k: float(v) for k, v in tm.items()}
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], METRIC_ATOL.get(k, 1e-5), f"epoch {e} {k}")
        assert tts.epoch == int(jts.epoch) == e
        assert int(tts.opt_state.count) == e * steps
        for name in ("obs_norm", "val_norm"):
            a, b = getattr(tts, name), getattr(jts, name)
            assert float(a.n) == float(b.n), (e, name)
            for f in ("mean", "var"):
                atol = OBS_MEAN_ATOL if (name, f) == ("obs_norm", "mean") else 1e-5
                _close(getattr(a, f).numpy(), np.asarray(getattr(b, f)), atol,
                       f"epoch {e} {name}.{f}")
        jp = CK.params_from_jax(_flatten(jts.params))
        for k, v in tts.params.items():
            np.testing.assert_allclose(v.detach().numpy(), jp[k].numpy(),
                                       atol=2 * sum(used), err_msg=f"epoch {e} {k}")
        assert len(used) == e * steps
        lrs.append(jm["lr"])
    if schedule == "linear":
        # epochs 0..3 -> 1 - epoch/4: factors 1.0, .75, .5, .25
        np.testing.assert_allclose(lrs, [LR * f for f in (1.0, 0.75, 0.5, 0.25)], rtol=1e-6)
    else:
        # the controller moved the lr both ways
        assert min(used) < LR < max(used), used
