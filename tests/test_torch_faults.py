"""Three departures of the port from the JAX package, repaired, each with its
case:

- the port's configs have every field of their JAX counterparts, with equal
  defaults (`TennisConfig.ball_bounce_x_half` was missing);
- a checkpoint's raw 2-byte void leaves (bf16 bytes, as JAX checkpoints
  written before the bf16 → f32 save conversion hold them) load to their
  bf16 values exactly;
- with two policies each sample takes its lane's output by a one-hot sum, as
  the JAX learner's einsum: a non-finite output of the other policy makes
  the sample non-finite (0·inf), in the forward and in the epoch, whose
  guarded update then skips every step as JAX's does.

The lane case runs one JAX `V2PPPO(num_policies=2)` epoch (4 envs, horizon 2,
one minibatch; one jit compile) with policy 1's mu bias set to inf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tennis import _state_arrays
from test_torch_tennis_env import build_envs, make_shared, step_draws
from vid2player3d_tpu.envs.humanoid_im import HumanoidImConfig as JHumanoidImConfig
from vid2player3d_tpu.envs.tennis import TennisConfig as JTennisConfig
from vid2player3d_tpu.learn.ppo import PPOConfig as JPPOConfig
from vid2player3d_tpu.learn.v2p_ppo import V2PConfig as JV2PConfig
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.envs import HumanoidImConfig, TennisConfig
from vid2player3d_torch.learn import PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)


@pytest.mark.parametrize("port,ref", [(TennisConfig, JTennisConfig),
                                      (HumanoidImConfig, JHumanoidImConfig),
                                      (PPOConfig, JPPOConfig), (V2PConfig, JV2PConfig)],
                         ids=["TennisConfig", "HumanoidImConfig", "PPOConfig", "V2PConfig"])
def test_config_fields_match_jax(port, ref):
    """Every field of the JAX config, in the port's, with an equal default
    (so every named configuration of the JAX CLI can be expressed)."""
    want = {f.name: f.default for f in dataclasses.fields(ref)}
    got = {f.name: f.default for f in dataclasses.fields(port)}
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}


def _bf16_void(values):
    """float32 values as raw bf16 bytes in a 2-byte void array, and the
    values those bytes hold."""
    t = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.dtype("V2")), t.float().numpy()


def test_bf16_void_leaves_load_exactly(tmp_path):
    """Params, running-norm statistics and MVAE weights saved as raw bf16
    bytes load to the bf16 values, bit for bit; f32 leaves beside them are
    unchanged."""
    vals = [1.0, -2.5, 0.15625, 3.140625, 1e-3, -65280.0]
    kernel, kernel_f = _bf16_void(np.reshape(vals, (2, 3)))
    bias, bias_f = _bf16_void(vals[:3])
    mean, mean_f = _bf16_void(vals)
    w, w_f = _bf16_void(np.reshape(vals * 2, (2, 2, 3)))
    path = str(tmp_path / "bf16.npz")
    np.savez(path, **{"params/params/mu/kernel": kernel, "params/params/mu/bias": bias,
                      "obs_norm/0": np.float32(3.0), "obs_norm/1": mean,
                      "obs_norm/2": np.ones(6, np.float32), "decoder/moe0/w": w})
    flat = CK.load_npz(path)
    assert flat["params/params/mu/kernel"].dtype == np.dtype("V2")
    params = CK.params_from_jax(flat)
    np.testing.assert_array_equal(params["mu.weight"].numpy(), kernel_f.T)
    np.testing.assert_array_equal(params["mu.bias"].numpy(), bias_f)
    norm = CK.running_norm_from_jax(flat, "obs_norm")
    np.testing.assert_array_equal(norm.mean.numpy(), mean_f)
    assert float(norm.n) == 3.0 and norm.mean.dtype == torch.float32
    np.testing.assert_array_equal(CK.mvae_params_from_jax(flat)["decoder.moe0.w"].numpy(), w_f)


N, T, MB = 4, 2, 8
ENV = dict(num_envs=N, substeps=2, max_episode_length=40, reset_reaction_nframes=6,
           reward_type="reach", use_random_ball_target="discrete")
LEARNER = dict(horizon=T, minibatch_size=MB, mini_epochs=1, actor_units=(32, 16),
               critic_units=(32, 16), compute_dtype="f32", num_policies=2)


@pytest.fixture(scope="module")
def lanes():
    jenv, tenv = build_envs(make_shared(), **ENV)
    jagent = JV2P(jenv, JV2PConfig(**LEARNER), seed=5)
    jts0 = jagent.init_state()
    p = jax.tree_util.tree_map(np.array, jts0.params)
    p["params"]["mu"]["bias"][1] = np.inf
    jts0 = dataclasses.replace(jts0, params=jax.tree_util.tree_map(jnp.asarray, p))
    params = CK.params_from_jax(_flatten(jts0.params))
    env_state0, obs0 = _state_arrays(jts0.env_state), np.asarray(jts0.last_obs)
    jfwd = [np.asarray(x) for x in jagent._forward(jts0.params, jts0.obs_norm, jts0.last_obs)]

    _, k_roll, k_shuffle, _ = jax.random.split(jts0.key, 4)
    noise, env_draws = [], []
    key, env_key = k_roll, jts0.env_state.key
    for _ in range(T):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, jenv.num_actions))))
        env_draws.append(step_draws(jenv, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perm = np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(jax.random.split(k_shuffle, 1)[0], 1)))
    draws = {"noise": np.stack(noise), "perms": perm, "env": env_draws}
    jts1, jm = jagent.train_epoch(jts0)

    tagent = V2PPPO(tenv, V2PConfig(**LEARNER), seed=5, device="cpu")
    tts0 = tagent.init_state(params)
    tts0.env_state = CK.tennis_state_from_jax(env_state0)
    tts0.last_obs = torch.tensor(obs0)
    with torch.no_grad():
        tfwd = [x.numpy() for x in tagent._forward(tts0.params, tts0.obs_norm, tts0.last_obs)]
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    return jfwd, tfwd, jm, tm, jts1, tts1, params


def test_other_lanes_inf_makes_the_sample_non_finite(lanes):
    """Policy 1's mu is inf on every row: the lane-0 rows come out NaN (0·inf)
    and the lane-1 rows inf, in the port exactly as in JAX; the value heads
    stay finite and equal."""
    jfwd, tfwd = lanes[:2]
    for j, t, name in zip(jfwd, tfwd, ("mu", "value")):
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=name)
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j), err_msg=name)
    assert np.isnan(tfwd[0][0::2]).all() and np.isinf(tfwd[0][1::2]).all()
    np.testing.assert_allclose(tfwd[1], jfwd[1], atol=1e-5)


def test_epoch_skips_every_update_as_jax(lanes):
    """The epoch's guarded update skips as JAX's does: the same `grad_skip`
    (every step), and the params (inf included) left as they were."""
    _, _, jm, tm, jts1, tts1, params = lanes
    assert float(tm["grad_skip"]) == float(jm["grad_skip"]) == 1.0
    jp = CK.params_from_jax(_flatten(jts1.params))
    for k, v in tts1.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), params[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(jp[k].numpy(), params[k].numpy(), err_msg=k)
    assert int(tts1.opt_state.count) == 0
