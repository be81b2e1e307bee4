"""The port's context-IK learner (`PPOConfig(use_context_ik=True)`, the
amass_im_corrupt configuration at test size) against the JAX learner's.

One JAX epoch at num_envs=4, horizon 4, minibatch 8, 2 mini-epochs,
`fused_optimizer="on"`, under amass_im_corrupt's corruption (one jit
compile). The test replays its key splits: epoch (`ppo.py` `_epoch`: roll,
shuffle, dr), rollout (`_rollout`: reset and action keys, a three-way split
per step), reset (`humanoid_im.py` `reset_all`: the time key, and the
corruption's key `split(key)[1]`, which `corrupt.py` splits into the
selection and noise keys and folds with 7 for the dropout) and the
per-mini-epoch permutations. Both start from the JAX init ({ac, ctx} params
through the checkpoint mapping) and run f32 on the CPU; the port's K1
wrapper runs its plain version here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.envs.corrupt import TransformSpecs as JSpecs
from vid2player3d_tpu.learn import FrozenImitator as JFrozen
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImEnv
from vid2player3d_torch.envs.presets import AMASS_IM_CORRUPT_SPECS, preset
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, LR = 4, 4, 8, 2, 7, 2e-5
SPECS = dict(noisy_joints_prob=0.5, noisy_joints_noise_std=0.02, noisy_joints_conf_std=0.02,
             noisy_joints_min_conf=0.1, mask_random_joints_prob=0.05)


def corrupt_draws(key, n, length):
    """The corruption draws `reset_all(key)` takes for n envs' contexts of
    `length` frames."""
    _, k_hybrid = jax.random.split(key)
    k_sel, k_noise = jax.random.split(k_hybrid)
    shape = (n, length, 24)
    return {"sel_u": np.asarray(jax.random.uniform(k_sel, shape)),
            "noise": np.asarray(jax.random.normal(k_noise, shape + (3,))),
            "drop_u": np.asarray(jax.random.uniform(jax.random.fold_in(k_hybrid, 7), shape))}


def _draws(jagent, jts):
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
    L = env.cfg.context_length + 2 * env.cfg.context_padding
    return {"motion_times": np.asarray(times), "noise": np.stack(noise),
            "perms": np.stack(perms), "corrupt": corrupt_draws(k_reset, N, L)}


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    jenv = JEnv(JEnvCfg(num_envs=N, substeps=2, transform_specs=JSpecs(**SPECS)),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, JPPOCfg(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS,
                                learning_rate=LR, fused_optimizer="on", use_context_ik=True),
                  seed=SEED)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    # the JAX reset of this epoch, for the forward's parity
    k_roll = jax.random.split(jts0.key, 4)[1]
    _, raw_obs, ctx = jenv.reset_all(jax.random.split(k_roll)[0])
    reset = {k: np.asarray(v) for k, v in dict(raw_obs=raw_obs, **ctx).items()}
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_ctx_epoch1.npz")
    jagent.save_checkpoint(ckpt, jts1)

    env_cfg, ppo_cfg = preset("amass_im_corrupt", num_envs=N)
    assert env_cfg.transform_specs == AMASS_IM_CORRUPT_SPECS and ppo_cfg.use_context_ik
    tenv = HumanoidImEnv(dataclasses.replace(env_cfg, substeps=2),
                         t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    tagent = ImitationPPO(tenv, dataclasses.replace(
        ppo_cfg, horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, learning_rate=LR,
        fused_optimizer="on"), seed=SEED, device="cpu")
    tts0 = tagent.init_state(init_params)
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    tm = {k: float(v) for k, v in tm.items()}
    return dict(jagent=jagent, jts1=jts1, jm=jm, tagent=tagent, tts1=tts1, tm=tm,
                init_params=init_params, ckpt=ckpt, reset=reset, draws=draws)


def test_reset_context_matches(epoch):
    """The port's reset fed the JAX draws: the corrupted context, its
    confidence (every occlusion and dropout exactly) and the raw obs."""
    tagent, reset, draws = epoch["tagent"], epoch["reset"], epoch["draws"]
    _, raw_obs, ctx = tagent.env.reset_all(motion_times=draws["motion_times"],
                                           corrupt_draws=draws["corrupt"])
    np.testing.assert_array_equal(ctx["conf"].numpy() == 0.0, reset["conf"] == 0.0)
    np.testing.assert_allclose(ctx["conf"].numpy(), reset["conf"], atol=1e-6)
    feat = ctx["feat"].numpy()
    # positions and dofs (the corrupted block included) to 1e-5; the body
    # rotations are the motion lib's quaternion lookup, held to 2e-4 in
    # tests/test_torch_core.py (2.3e-4 measured here): 5e-4
    np.testing.assert_allclose(feat[..., :72], reset["feat"][..., :72], atol=1e-5)
    np.testing.assert_allclose(feat[..., 168:], reset["feat"][..., 168:], atol=1e-5)
    np.testing.assert_allclose(feat[..., 72:168], reset["feat"][..., 72:168], atol=5e-4)
    np.testing.assert_allclose(raw_obs.numpy(), reset["raw_obs"], atol=1e-5)
    assert 0.0 < float((ctx["conf"] == 0.0).float().mean()) < 0.5


def test_context_targets_and_forward_match(epoch):
    """`_context_targets` and `_forward` on the JAX reset's context with the
    trained params (non-zero heads): targets, observation, mu and value to
    1e-4 (the IK's rotations pass through angle-axis and quaternion
    conversions); the normalized observation to 1e-4 of the running std
    it is divided by."""
    jagent, jts1, tagent, tts1, reset = (epoch[k] for k in ("jagent", "jts1", "tagent",
                                                            "tts1", "reset"))
    t = 2
    jframe = jagent._ctx_frame(jnp.asarray(reset["feat"]), t)
    conf = reset["conf"][:, jagent.env.cfg.context_padding + t]
    want = jagent._context_targets(jts1.params, jframe[0], jnp.asarray(conf),
                                   jagent.env.rest_joints_smpl)
    got = tagent._context_targets(tts1.params, torch.tensor(np.asarray(jframe[0])),
                                  torch.tensor(conf), tagent.env.rest_joints_smpl)
    for g, w, name in zip(got, want, ("dof", "pos", "rot", "local")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, err_msg=name)
    jout = jagent._forward(jagent.env, jts1.params, jts1.obs_norm, jnp.asarray(reset["raw_obs"]),
                           jnp.asarray(reset["feat"]), t, jnp.asarray(reset["conf"]))
    with torch.no_grad():
        tout = tagent._forward(tts1.params, tts1.obs_norm, torch.tensor(reset["raw_obs"]),
                               torch.tensor(reset["feat"]), t, torch.tensor(reset["conf"]))
    std = np.sqrt(np.asarray(jts1.obs_norm.var)) + 1e-8
    for g, w, name in zip(tout, jout, ("io", "io_n", "mu", "value", "dof")):
        atol = 1e-4 / std if name == "io_n" else 1e-4
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= atol), name


# the bounds of tests/test_torch_epoch.py; the auxiliary losses see the IK of
# the same context
METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-4, "kl": 1e-5, "clip_frac": 1e-6,
               "lr": 0.0, "aux_dof_loss": 1e-5, "aux_pos_loss": 1e-6}


def test_epoch_metrics_match(epoch):
    jm, tm = epoch["jm"], epoch["tm"]
    assert set(tm) == set(jm) and {"aux_dof_loss", "aux_pos_loss"} <= set(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
    assert tm["aux_dof_loss"] > 0.0 and np.isfinite(tm["aux_pos_loss"])


def test_epoch_params_match(epoch):
    """All 24 leaves (the context heads' 8 included) within 2·steps·lr
    elementwise, the whole update within 10% in norm (the bound of
    tests/test_torch_epoch.py)."""
    jts1, tts1, init_params = epoch["jts1"], epoch["tts1"], epoch["init_params"]
    jp = CK.params_from_jax(_flatten(jts1.params))
    assert len(tts1.params) == 24 and sum(k.startswith("ctx.") for k in tts1.params) == 8
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
    assert float(tts1.params["ctx.phis.weight"].detach().abs().max()) > 0.0
    assert int(tts1.opt_state.count) == n_steps and tts1.epoch == 1


def test_load_jax_context_ik_checkpoint(epoch):
    """The port reads the JAX context-IK checkpoint: both trees' params and
    Adam moments, the count, the normalizers and the epoch exactly; and
    `FrozenImitator` keeps its actor-critic alone, giving JAX's mu."""
    jts1, tagent, ckpt = epoch["jts1"], epoch["tagent"], epoch["ckpt"]
    ts = tagent.load_checkpoint(ckpt)
    jp = CK.params_from_jax(_flatten(jts1.params))
    assert sorted(ts.params) == sorted(jp)
    for k, v in ts.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), jp[k].numpy(), err_msg=k)
    adam = jts1.opt_state[1]
    for moments, jmom in ((ts.opt_state.mu, adam.mu), (ts.opt_state.nu, adam.nu)):
        jmom = CK.params_from_jax(_flatten(jmom))
        for k, m in zip(ts.params, moments):
            np.testing.assert_array_equal(m.numpy(), jmom[k].numpy(), err_msg=k)
    assert int(ts.opt_state.count) == int(adam.count)
    np.testing.assert_array_equal(ts.obs_norm.mean.numpy(), np.asarray(jts1.obs_norm.mean))
    assert ts.epoch == int(jts1.epoch) == 1

    frozen = FrozenImitator.from_checkpoint(ckpt, device="cpu")
    jfrozen = JFrozen.from_checkpoint(ckpt)
    obs = np.random.default_rng(0).standard_normal((3, 734)).astype(np.float32)
    pi_low, pparams = jfrozen.as_pi_low()
    with torch.no_grad():
        mu = frozen(torch.tensor(obs))
    np.testing.assert_allclose(mu.numpy(), np.asarray(pi_low(pparams, jnp.asarray(obs))),
                               atol=1e-5)
    assert sorted(frozen.net.state_dict()) == sorted(k[3:] for k in jp if k.startswith("ac."))


def test_k1_host_table_follows_the_leaf_list():
    """K1's host table of pointers is rebuilt when the learner's leaf list
    changes (16 leaves, then the context-IK learner's 24), and reused while
    the same tensors come back."""
    from vid2player3d_torch.ops import fused_adam as FA

    def leaves(n):
        ps = [torch.zeros(3) for _ in range(n)]
        return ps, [torch.zeros(3) for _ in ps], [torch.zeros(3) for _ in ps]

    small, large = leaves(16), leaves(24)
    t16 = FA._leaves(*small)
    assert len(t16.numel) == 16 and FA._leaves(*small) is t16
    t24 = FA._leaves(*large)
    assert t24 is not t16 and len(t24.numel) == 24
    assert list(t24.rows[:, 0]) == [p.data_ptr() for p in large[0]]
    assert FA._leaves(*large) is t24
