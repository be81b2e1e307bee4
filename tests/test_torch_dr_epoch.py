"""One domain-randomized `ImitationPPO.train_epoch` of the port against the
JAX learner's (amass_im_dr's four specs at test size), fed the JAX draws; two
port epochs that show the perturbation is drawn from the base model every
epoch; and the three presets against the JAX package's named configs.

The JAX epoch runs at num_envs=4, horizon 4, minibatch 8, 2 mini-epochs,
`fused_optimizer="on"` (one jit compile), from epoch 300: the schedule step
epoch·horizon = 1200 puts the linear obs and action noise at 0.4 of their
strength (at epoch 0 it would be 0). The test replays the key splits of
`ppo.py` `_epoch` (the model draws from `fold_in(k_dr, i)`), `_rollout`
(per step `split(key, 3)`: action noise from the second key, the obs and
action randomization from the third, folded with 1000 + i and 2000 + i) and
the permutations, as tests/test_torch_epoch.py does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.cli.configs import get_config
from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImEnv
from vid2player3d_torch.envs.presets import PRESETS, preset
from vid2player3d_torch.learn import ImitationPPO
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, LR, EPOCH = 4, 4, 8, 2, 7, 2e-5, 300
SMALL = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, learning_rate=LR,
             fused_optimizer="on")


def _std(key, spec, shape):
    if spec.distribution == "gaussian":
        return np.asarray(jax.random.normal(key, shape))
    return np.asarray(jax.random.uniform(key, shape))


def _draws(jagent, jts):
    env, cfg, dr = jagent.env, jagent.cfg, jagent.env.randomizer
    _, k_roll, k_shuffle, k_dr = jax.random.split(jts.key, 4)
    k_reset, key = jax.random.split(k_roll)
    k_time, _ = jax.random.split(k_reset)
    times = JML.sample_time(env.lib, k_time, env.motion_ids,
                            truncate_time=env.cfg.context_length * env.cfg.control_dt)
    noise, dr_act, dr_obs = [], [], []
    for _ in range(cfg.horizon):
        key, k, k_n = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
        dr_act.append([_std(jax.random.fold_in(k_n, 2000 + i), sp, (N, env.num_actions))
                       for i, sp in enumerate(dr.act_specs)])
        dr_obs.append([_std(jax.random.fold_in(k_n, 1000 + i), sp, (N, env.obs_dim))
                       for i, sp in enumerate(dr.obs_specs)])
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(k, 1)))[0] for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    dr_model = [_std(jax.random.fold_in(k_dr, i), sp, (N,)) for i, sp in enumerate(dr.model_specs)]
    return {"motion_times": np.asarray(times), "noise": np.stack(noise),
            "perms": np.stack(perms), "dr_model": dr_model, "dr_act": dr_act, "dr_obs": dr_obs}


def _port_agent(motion_ids):
    env_cfg, ppo_cfg = preset("amass_im_dr", num_envs=N, substeps=2)
    env = HumanoidImEnv(env_cfg, t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                        motion_ids=motion_ids, device="cpu")
    return ImitationPPO(env, dataclasses.replace(ppo_cfg, **SMALL), seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def epoch():
    cfg = get_config("amass_im_dr")
    jenv = JEnv(dataclasses.replace(cfg.env_im, num_envs=N, substeps=2),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, dataclasses.replace(cfg.ppo, **SMALL), seed=SEED)
    jts0 = dataclasses.replace(jagent.init_state(), epoch=jnp.asarray(EPOCH, jnp.int32))
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}

    tagent = _port_agent(np.asarray(jenv.motion_ids))
    tts0 = tagent.init_state(init_params)
    tts0.epoch = EPOCH
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    tm = {k: float(v) for k, v in tm.items()}
    return jagent, jts1, jm, tagent, tts1, tm, init_params, draws


METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5, "clip_frac": 1e-6,
               "lr": 0.0}


def test_dr_epoch_metrics_match(epoch):
    """Every metric, within the bounds of tests/test_torch_epoch.py; the
    epoch stepped a model perturbed by the JAX draws."""
    jagent, _, jm, tagent, _, tm, _, draws = epoch
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
    base = tagent.env.model
    ratio = (tagent.last_env.model.body_mass / base.body_mass).numpy()
    np.testing.assert_allclose(ratio[:, 0], 0.9 + 0.2 * draws["dr_model"][0], rtol=1e-6)
    want_kp = jagent.env.randomizer.randomize_model(
        jax.random.split(jax.random.PRNGKey(SEED), 4)[3], jagent.env.model, step=EPOCH * T).kp
    np.testing.assert_allclose(tagent.last_env.model.kp.numpy(), np.asarray(want_kp), rtol=1e-6)


def test_dr_epoch_params_match(epoch):
    """The bounds of tests/test_torch_epoch.py: 2·steps·lr elementwise, the
    whole update within 10% in norm."""
    _, jts1, _, _, tts1, _, init_params, _ = epoch
    jp = CK.params_from_jax(_flatten(jts1.params))
    n_steps = MINI_EPOCHS * (N * T // MB)
    diff2 = ref2 = 0.0
    for k, v in tts1.params.items():
        got = v.detach().numpy()
        np.testing.assert_allclose(got, jp[k].numpy(), atol=2 * n_steps * LR, err_msg=k)
        du = (got - init_params[k].numpy()) - (jp[k].numpy() - init_params[k].numpy())
        diff2 += float((du ** 2).sum())
        ref2 += float(((jp[k].numpy() - init_params[k].numpy()) ** 2).sum())
    assert ref2 > 0.0
    assert np.sqrt(diff2) <= 0.1 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))
    assert tts1.epoch == EPOCH + 1 and int(tts1.opt_state.count) == n_steps


def test_two_epochs_do_not_compound():
    """Each epoch's model is the base model times that epoch's factors: the
    env keeps its own model, and the second epoch's perturbation is drawn
    from it, not from the first epoch's."""
    agent = _port_agent(np.array([0, 1, 1, 0]))
    base = {f: getattr(agent.env.model, f).clone() for f in ("body_mass", "kp")}
    ts = agent.init_state()
    rng = np.random.default_rng(0)
    models = []
    for e in range(2):
        u = [rng.random(N).astype(np.float32) for _ in range(2)]
        draws = {"dr_model": u}
        want = agent.env.randomizer.randomize_model(agent.env.model, e * T, draws=u)
        assert torch.equal(agent.epoch_env(ts, draws).model.body_mass, want.body_mass)
        ts, m = agent.train_epoch(ts)
        models.append(agent.last_env.model)
        assert np.isfinite(float(m["a_loss"]))
    bounds = {"body_mass": (0.9, 1.1), "kp": (0.85, 1.15)}
    for f, v in base.items():
        assert torch.equal(getattr(agent.env.model, f), v), f
        lo, hi = bounds[f]
        for mdl in models:
            r = (getattr(mdl, f) / v).numpy()
            assert (r >= lo - 1e-6).all() and (r <= hi + 1e-6).all(), f
    assert not torch.equal(models[0].body_mass, models[1].body_mass)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "rand_specs" and v is not None:
            v = tuple(dataclasses.astuple(s) for s in v)
        elif f.name == "transform_specs" and v is not None:
            v = dataclasses.astuple(v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal_the_jax_configs(name):
    """The port's copies of amass_im_dr, amass_im_corrupt and
    federer_train_stage_1_dr hold the JAX package's values, field by
    field."""
    cfg = get_config(name)
    env_cfg, learner_cfg = preset(name)
    jenv = cfg.env_im if cfg.env_im is not None else cfg.env_tennis
    jlearner = cfg.ppo if cfg.ppo is not None else cfg.v2p
    assert _fields(env_cfg) == _fields(jenv)
    assert _fields(learner_cfg) == _fields(jlearner)
