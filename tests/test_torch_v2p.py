"""One `V2PPPO.train_epoch` of the port against the JAX learner's, fed the
JAX draws.

The JAX epoch runs at 4 envs (2 substeps, `return` reward, discrete targets,
the full-width frozen π_low of tests/test_torch_tennis_env.py), horizon 4,
minibatch 8, 2 mini-epochs, V2PNet trunks (64, 32), the dof-residual aux
loss and the adaptive lr schedule: one jit compile. The test replays its
key splits with `jax.random`: epoch (`v2p_ppo.py` `_epoch`: roll, shuffle,
dr), rollout (three-way split per step: action noise), the env's per-step
splits (`envs/tennis.py` `step`) and the per-mini-epoch permutations, and
hands the draws to the port. Both start from the same params and the same
env state (copied from the JAX train state) and run f32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_tennis import _state_arrays
from test_torch_tennis_env import build_envs, make_shared, step_draws
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.learn import V2PConfig, V2PPPO
from vid2player3d_torch.learn.v2p_ppo import nanmedian
from vid2player3d_torch.parallel import mesh as PM
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED = 4, 4, 8, 2, 3
ENV = dict(num_envs=N, substeps=2, max_episode_length=40, reset_reaction_nframes=6,
           reward_type="return", use_random_ball_target="discrete")
LEARNER = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, actor_units=(64, 32),
               critic_units=(64, 32), aux_dof_res_coef=0.01, lr_schedule="adaptive",
               compute_dtype="f32")


def _draws(jagent, jts):
    """Replay the JAX epoch's key splits into explicit draws."""
    cfg, env = jagent.cfg, jagent.env
    _, k_roll, k_shuffle, _ = jax.random.split(jts.key, 4)
    noise, env_draws = [], []
    key, env_key = k_roll, jts.env_state.key
    for _ in range(cfg.horizon):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
        env_draws.append(step_draws(env, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(k, 1)))[0] for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    return {"noise": np.stack(noise), "perms": np.stack(perms), "env": env_draws}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX epoch (one jit compile), its draws and its start, and the
    port's env."""
    jenv, tenv = build_envs(make_shared(), **ENV)
    jagent = JV2P(jenv, JV2PCfg(**LEARNER), seed=SEED)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    env_state0 = _state_arrays(jts0.env_state)
    last_obs0 = np.asarray(jts0.last_obs)
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}
    return dict(jts1=jts1, jm=jm, draws=draws, init_params=init_params, env_state0=env_state0,
                last_obs0=last_obs0, tagent=V2PPPO(tenv, V2PConfig(**LEARNER), seed=SEED,
                                                   device="cpu"))


def _port_start(run):
    """The port's train state at the JAX epoch's start."""
    tts0 = run["tagent"].init_state(params=run["init_params"])
    tts0.env_state = CK.tennis_state_from_jax(run["env_state0"])
    tts0.last_obs = torch.tensor(run["last_obs0"])
    return tts0


@pytest.fixture(scope="module")
def epoch(jax_run):
    tts1, tm = jax_run["tagent"].train_epoch(_port_start(jax_run), draws=jax_run["draws"])
    tm = {k: float(v) for k, v in tm.items()}
    return jax_run["jts1"], jax_run["jm"], tts1, tm, jax_run["init_params"]


# the losses see the network on rollout observations that agree to ~1e-5
# (tests/test_torch_tennis_env.py); the behavioral metrics are counts and
# quantiles of the same per-step values
METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5, "lr": 1e-9}


def test_epoch_metrics_match(epoch):
    """Every metric of the JAX epoch, the racket-ball distance median and
    P90 included; the epoch saw in-reaction frames and no skipped update."""
    _, jm, _, tm, _ = epoch
    _hold_metrics(tm, jm)


def _hold_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
    assert tm["grad_skip"] == 0.0 and np.isfinite(tm["racket_ball_dist"])


def test_epoch_params_and_state_match(epoch):
    """New params after the 4 Adam steps. Slice 1's bound
    (tests/test_torch_epoch.py: 2·Σlr, since Adam moves an element whose
    gradient is float noise by up to lr either way) is far looser than what
    this epoch reaches: its gradients are not noise-dominated, and the new
    params agree to 1.0e-7 with the whole update equal to 4.4e-6 in norm
    (measured). Held: 2e-6 elementwise and 1e-3 of the update's norm. The
    running obs / value normalizers and the carried env state after the
    epoch agree to 1e-4."""
    jts1, _, tts1, _, init_params = epoch
    _hold_state(jts1, tts1, init_params)


def _hold_state(jts1, tts1, init_params):
    jp = CK.params_from_jax(_flatten(jts1.params))
    n_steps = MINI_EPOCHS * (N * T // MB)
    diff2 = ref2 = 0.0
    for k, v in tts1.params.items():
        got = v.detach().numpy()
        np.testing.assert_allclose(got, jp[k].numpy(), atol=2e-6, err_msg=k)
        du = got - jp[k].numpy()
        diff2 += float((du ** 2).sum())
        ref2 += float(((jp[k].numpy() - init_params[k].numpy()) ** 2).sum())
    assert ref2 > 0.0
    assert np.sqrt(diff2) <= 1e-3 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))
    assert int(tts1.opt_state.count) == n_steps and tts1.epoch == 1
    for name in ("obs_norm", "val_norm"):
        j, t = getattr(jts1, name), getattr(tts1, name)
        assert float(t.n) == float(j.n)
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t.var.numpy(), np.asarray(j.var), atol=1e-4, rtol=1e-4)
    want, got = _state_arrays(jts1.env_state), _state_arrays(tts1.env_state)
    for k, v in want.items():
        if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tts1.last_obs.numpy(), np.asarray(jts1.last_obs), atol=1e-4)


def test_graphed_epoch_matches_jax(jax_run, epoch):
    """The staged epoch (`_train_epoch_graphed`, each env and optimizer step
    one `StaticGraph` call, as the card replays them) on the JAX learner's
    draws: every metric, the params, the norms and the carried env state at
    the bounds of the two tests above, and bit for bit with the eager epoch
    on the same draws."""
    ts, m = jax_run["tagent"]._train_epoch_graphed(_port_start(jax_run),
                                                    draws=jax_run["draws"])
    tm = {k: float(v) for k, v in m.items()}
    jts1, jm, ref, ref_m, init_params = epoch
    _hold_metrics(tm, jm)
    _hold_state(jts1, ts, init_params)
    assert tm.keys() == ref_m.keys()
    for k in tm:
        assert tm[k] == ref_m[k] or (np.isnan(tm[k]) and np.isnan(ref_m[k])), k
    for k in ts.params:
        torch.testing.assert_close(ts.params[k], ref.params[k], rtol=0, atol=0, msg=k)
    for x, y in zip(PM.tree_leaves((ts.env_state, ts.last_obs, ts.opt_state.mu, ts.opt_state.nu)),
                    PM.tree_leaves((ref.env_state, ref.last_obs, ref.opt_state.mu,
                                    ref.opt_state.nu))):
        assert torch.equal(x, y)


def test_nanmedian_is_numpys():
    """The median metric averages the two middle values of an even count,
    as `jnp.nanmedian` does (`torch.nanmedian` takes the lower one)."""
    x = torch.tensor([[1.0, float("nan"), 4.0], [2.0, 8.0, float("nan")]])
    assert float(nanmedian(x)) == float(np.nanmedian(x.numpy())) == 3.0
    assert float(torch.nanmedian(x)) == 2.0


def test_grad_skip_keeps_params_and_moments():
    """A non-finite gradient element skips the whole update: params, both
    Adam moments and the step count stay as they were."""
    from vid2player3d_torch.learn.optim import init_adam
    from vid2player3d_torch.learn.v2p_ppo import _guarded_adam_step

    params = [torch.ones(3), torch.zeros(2)]
    opt = init_adam(params)
    grads = [torch.tensor([0.1, float("nan"), 0.2]), torch.ones(2)]
    new, ok = _guarded_adam_step(params, opt, grads, torch.tensor(1e-2), 50.0)
    assert not bool(ok) and int(new.count) == 0
    torch.testing.assert_close(params[0], torch.ones(3), rtol=0.0, atol=0.0)
    for m in new.mu + new.nu:
        assert float(m.abs().sum()) == 0.0
    new, ok = _guarded_adam_step(params, new, [torch.ones(3), torch.ones(2)],
                                 torch.tensor(1e-2), 50.0)
    assert bool(ok) and int(new.count) == 1
    torch.testing.assert_close(params[0], torch.full((3,), 0.99), rtol=0.0, atol=1e-7)
