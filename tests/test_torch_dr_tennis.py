"""One domain-randomized `V2PPPO.train_epoch` of the port against the JAX
learner's: federer_train_stage_1_dr's four specs (the ball's restitution and
drag per epoch, obs and action noise per step) on the stage-1 env at test
size, fed the JAX draws.

The env and learner are tests/test_torch_v2p.py's (4 envs, 2 substeps,
reach reward, discrete targets, here with K = 2 candidate resets as stage 1
has them; trunks (64, 32); horizon 4, minibatch 8, 2 mini-epochs), from
epoch 400: the schedule step 1600 puts the noise at 0.53 of its strength.
The test replays `v2p_ppo.py` `_epoch`'s key splits: the ball draws from
`fold_in(fold_in(k_dr, 1), 3000 + i)`; per step `split(key, 3)`, the action
noise from the second key and the obs and action randomization from the
third (folded with 1000 + i and 2000 + i); the env's own per-step draws as
tests/test_torch_tennis_env.py replays them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tennis import _port_spec, _state_arrays
from test_torch_tennis_env import make_shared, step_draws
from vid2player3d_tpu.cli.configs import get_config
from vid2player3d_tpu.envs import TennisEnv as JEnv
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.envs import TennisEnv
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import V2PConfig, V2PPPO
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, EPOCH = 4, 4, 8, 2, 3, 400
ENV = dict(num_envs=N, substeps=2, max_episode_length=40, reset_reaction_nframes=6,
           reset_candidates=2)
LEARNER = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, actor_units=(64, 32),
               critic_units=(64, 32), aux_dof_res_coef=0.01, compute_dtype="f32")


def _std(key, spec, shape):
    if spec.distribution == "gaussian":
        return np.asarray(jax.random.normal(key, shape))
    return np.asarray(jax.random.uniform(key, shape))


def _draws(jagent, jts):
    cfg, env, dr = jagent.cfg, jagent.env, jagent.env.randomizer
    _, k_roll, k_shuffle, k_dr = jax.random.split(jts.key, 4)
    k_ball = jax.random.fold_in(k_dr, 1)
    noise, env_draws, dr_act, dr_obs = [], [], [], []
    key, env_key = k_roll, jts.env_state.key
    for _ in range(cfg.horizon):
        key, k, k_n = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
        dr_act.append([_std(jax.random.fold_in(k_n, 2000 + i), sp, (N, env.num_actions))
                       for i, sp in enumerate(dr.act_specs)])
        dr_obs.append([_std(jax.random.fold_in(k_n, 1000 + i), sp, (N, env.obs_dim))
                       for i, sp in enumerate(dr.obs_specs)])
        env_draws.append(step_draws(env, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(k, 1)))[0] for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    dr_ball = [_std(jax.random.fold_in(k_ball, 3000 + i), sp, ())
               for i, sp in enumerate(dr.ball_specs)]
    return {"noise": np.stack(noise), "perms": np.stack(perms), "env": env_draws,
            "dr_ball": dr_ball, "dr_act": dr_act, "dr_obs": dr_obs}


@pytest.fixture(scope="module")
def epoch():
    jspec, feats, jgen, jfrozen, tfrozen = make_shared()
    pi_low, pi_params = jfrozen.as_pi_low()
    jcfg = get_config("federer_train_stage_1_dr")
    jenv = JEnv(dataclasses.replace(jcfg.env_tennis, **ENV), jspec, feats, ball_generator=jgen,
                pi_low=pi_low, pi_low_params=pi_params)
    jagent = JV2P(jenv, JV2PCfg(**LEARNER), seed=SEED)
    jts0 = dataclasses.replace(jagent.init_state(), epoch=jnp.asarray(EPOCH, jnp.int32))
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    env_state0 = _state_arrays(jts0.env_state)
    last_obs0 = np.asarray(jts0.last_obs)
    want_ball = jenv.randomizer.randomize_ball(
        jax.random.fold_in(jax.random.split(jts0.key, 4)[3], 1), jenv.ball_params,
        step=EPOCH * T)
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}

    env_cfg, _ = preset("federer_train_stage_1_dr", **ENV)
    tenv = TennisEnv(env_cfg, _port_spec(jspec), feats,
                     ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"),
                     pi_low=tfrozen.as_pi_low(), device="cpu")
    tagent = V2PPPO(tenv, V2PConfig(**LEARNER), seed=SEED, device="cpu")
    tts0 = tagent.init_state(params=init_params)
    tts0.env_state = CK.tennis_state_from_jax(env_state0)
    tts0.last_obs = torch.tensor(last_obs0)
    tts0.epoch = EPOCH
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    tm = {k: float(v) for k, v in tm.items()}
    return jagent, jts1, jm, tagent, tts1, tm, init_params, draws, want_ball


# the bounds of tests/test_torch_v2p.py
METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5, "lr": 1e-9}


def test_dr_epoch_metrics_and_ball_match(epoch):
    """Every metric of the JAX epoch (no skipped update), and the ball
    constants the epoch flew: restitution and drag perturbed by the JAX
    draws, the others the base's."""
    _, _, jm, tagent, _, tm, _, _, want_ball = epoch
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
    assert tm["grad_skip"] == 0.0
    got = tagent.last_env.ball_params
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want_ball, name)),
                                   rtol=1e-6, err_msg=name)
    assert isinstance(got.restitution, torch.Tensor) and got.restitution.dim() == 0
    assert got.restitution != tagent.env.ball_params.restitution
    assert tagent.env.ball_params == type(got)()


def test_dr_epoch_params_and_state_match(epoch):
    """The bounds of tests/test_torch_v2p.py: new params to 2e-6 elementwise
    and 1e-3 of the update's norm; the normalizers and the carried env state
    to 1e-4."""
    _, jts1, _, _, tts1, _, init_params, _, _ = epoch
    jp = CK.params_from_jax(_flatten(jts1.params))
    diff2 = ref2 = 0.0
    for k, v in tts1.params.items():
        got = v.detach().numpy()
        np.testing.assert_allclose(got, jp[k].numpy(), atol=2e-6, err_msg=k)
        diff2 += float(((got - jp[k].numpy()) ** 2).sum())
        ref2 += float(((jp[k].numpy() - init_params[k].numpy()) ** 2).sum())
    assert ref2 > 0.0
    assert np.sqrt(diff2) <= 1e-3 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))
    assert tts1.epoch == EPOCH + 1
    for name in ("obs_norm", "val_norm"):
        j, t = getattr(jts1, name), getattr(tts1, name)
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t.var.numpy(), np.asarray(j.var), atol=1e-4, rtol=1e-4)
    want, got = _state_arrays(jts1.env_state), _state_arrays(tts1.env_state)
    for k, v in want.items():
        if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tts1.last_obs.numpy(), np.asarray(jts1.last_obs), atol=1e-4)
