"""One `train_epoch` of the port against the JAX learner, fed the JAX
learner's draws, with `fused_optimizer="on"`; and the port reading the JAX
checkpoint of the trained state.

The JAX epoch runs at num_envs=4, horizon 4, minibatch 8, mini_epochs 2 (one
jit compile). The test replays its key splits with `jax.random` — epoch
(`ppo.py` `_epoch`: split into roll/shuffle/dr), rollout (`_rollout`: reset
and action keys, three-way split per step), reset (`humanoid_im.py`
`reset_all`: time key) and the per-mini-epoch permutations — and hands the
draws to the port. Both start from the same params (the JAX init, copied
through the checkpoint mapping) and run f32 on the CPU; on the CPU the port's
K1 wrapper runs its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.learn import ImitationPPO, PPOConfig
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, LR = 4, 4, 8, 2, 7, 2e-5


def _draws(jagent, jts):
    """Replay the JAX epoch's key splits into explicit draws."""
    env, cfg = jagent.env, jagent.cfg
    _, k_roll, k_shuffle, _ = jax.random.split(jts.key, 4)
    k_reset, key = jax.random.split(k_roll)
    k_time, _ = jax.random.split(k_reset)
    times = JML.sample_time(env.lib, k_time, env.motion_ids,
                            truncate_time=env.cfg.context_length * env.cfg.control_dt)
    noise = []
    for _ in range(cfg.horizon):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(k, 1)))[0] for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    return {"motion_times": np.asarray(times), "noise": np.stack(noise),
            "perms": np.stack(perms)}


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    jenv = JEnv(JEnvCfg(num_envs=N, substeps=2),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, JPPOCfg(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS,
                                learning_rate=LR, fused_optimizer="on"), seed=SEED)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_epoch1.npz")
    jagent.save_checkpoint(ckpt, jts1)

    tenv = HumanoidImEnv(HumanoidImConfig(num_envs=N, substeps=2),
                         t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    tagent = ImitationPPO(tenv, PPOConfig(horizon=T, minibatch_size=MB,
                                          mini_epochs=MINI_EPOCHS, learning_rate=LR,
                                          fused_optimizer="on"), seed=SEED, device="cpu")
    tts0 = tagent.init_state(init_params)
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    tm = {k: float(v) for k, v in tm.items()}
    return jagent, jts1, jm, tagent, tts1, tm, init_params, ckpt


# Metrics from the rollout (rewards, alive, success) see the physics through
# four control steps (see test_torch_env for how one-ulp differences grow);
# the loss statistics also see the network on those observations.
METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5,
               "clip_frac": 1e-6, "lr": 0.0}


def test_epoch_metrics_match(epoch):
    _, _, jm, _, _, tm, _, _ = epoch
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5),
                                   rtol=1e-4, err_msg=k)


def test_epoch_params_match(epoch):
    """The four Adam steps of the epoch move every parameter by at most
    4·lr = 8e-5, and Adam normalizes each gradient by its own running RMS:
    an element whose gradient is float noise around zero moves by up to ±lr
    per step in either framework, whatever its size. So the absolute
    tolerance on the new params is 2·4·lr (opposite signs every step). The
    rollout's velocity observations agree only to ~1e-3 (test_torch_env), so
    gradients at that noise level take either sign: the total update of the
    whole tree agrees to 3.7% in norm (measured); it is held to 10%."""
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
    assert int(tts1.opt_state.count) == n_steps
    assert tts1.epoch == 1


def test_load_jax_checkpoint(epoch):
    """The port reads the JAX learner's `.npz` checkpoint: params, Adam
    moments and count, both running normalizers, epoch and lr, exactly."""
    jagent, jts1, _, tagent, _, _, _, ckpt = epoch
    ts = tagent.load_checkpoint(ckpt)
    jp = CK.params_from_jax(_flatten(jts1.params))
    for k, v in ts.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), jp[k].numpy(), err_msg=k)
    adam = jts1.opt_state[1]
    jmu = CK.params_from_jax(_flatten(adam.mu))
    for k, m in zip(ts.params, ts.opt_state.mu):
        np.testing.assert_array_equal(m.numpy(), jmu[k].numpy(), err_msg=k)
    assert int(ts.opt_state.count) == int(adam.count)
    np.testing.assert_array_equal(ts.obs_norm.mean.numpy(), np.asarray(jts1.obs_norm.mean))
    np.testing.assert_array_equal(ts.obs_norm.var.numpy(), np.asarray(jts1.obs_norm.var))
    assert float(ts.obs_norm.n) == float(jts1.obs_norm.n)
    np.testing.assert_array_equal(ts.val_norm.var.numpy(), np.asarray(jts1.val_norm.var))
    assert ts.epoch == int(jts1.epoch) == 1
