"""`ImitationPPO` over two gloo ranks on the CPU against the JAX learner's
epoch over a 2-device CPU mesh (`vid2player3d_tpu.parallel.data_parallel_mesh
(2)`), and against the port's own one-process epoch.

Two cases, each one JAX jit compile, as the JAX learner's data-parallel
modes (`learn/ppo.py` `_epoch`):
- `per_minibatch`: a global minibatch of 8 (4 rows per shard), the fused
  optimizer (K1's plain version on the CPU), 2 mini-epochs of 2 steps;
- `local_sgd`: `minibatch_per_chip` (4 rows per shard, so 2 steps per
  mini-epoch) with `dp_sync="per_mini_epoch"`: each shard steps its own
  minibatches with the optax-chain Adam and the params and both moments
  are averaged after each of the 2 mini-epochs.

4 envs (2 per rank), horizon 4, f32. The ranks get the draws the JAX key
chain makes: the reset times and the action noise (global, each rank keeps
its block) and one permutation per shard per mini-epoch, (dp, local batch).
Both frameworks start from the JAX init params.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from vid2player3d_tpu import parallel as JPL
from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MINI_EPOCHS, SEED, LR, DP = 4, 4, 2, 7, 2e-5, 2
CASES = {"per_minibatch": dict(minibatch_size=8, fused_optimizer="on"),
         "local_sgd": dict(minibatch_size=4, minibatch_per_chip=True,
                           dp_sync="per_mini_epoch")}
ROLLOUT = ("reward_mean", "alive_ratio", "episode_return", "dof_reward", "vel_reward",
           "body_pos_reward", "body_rot_reward", "success_rate")


def _draws(jagent, jts):
    """The JAX mesh epoch's key splits as explicit draws (`tests/test_torch_
    epoch.py`'s, with one permutation per shard)."""
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
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T // DP))(
        jax.random.split(k, DP))) for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    return {"motion_times": np.asarray(times), "noise": np.stack(noise),
            "perms": np.stack(perms)}


@pytest.fixture(scope="module", params=list(CASES))
def epoch(request):
    kw = CASES[request.param]
    jmesh = JPL.data_parallel_mesh(DP, devices=jax.devices("cpu"))
    jenv = JEnv(JEnvCfg(num_envs=N, substeps=2),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0).shard(jmesh)
    jagent = JPPO(jenv, JPPOCfg(horizon=T, mini_epochs=MINI_EPOCHS, learning_rate=LR, **kw),
                  seed=SEED, mesh=jmesh)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}

    case = dict(lib=dict(num_motions=2, T=60, fps=30.0, seed=0),
                env=dict(num_envs=N, substeps=2), motion_ids=np.asarray(jenv.motion_ids),
                ppo=dict(horizon=T, mini_epochs=MINI_EPOCHS, learning_rate=LR, **kw),
                seed=SEED, params=init_params, draws=draws)
    # the one-process run: each minibatch the union of the shards' minibatches
    mb_local = kw["minibatch_size"] // (1 if kw.get("minibatch_per_chip") else DP)
    one_draws = dict(draws, perms=np.stack([W.interleaved_perm(p, mb_local)
                                            for p in draws["perms"]]))
    one = W.imitation_epoch(None, dict(case, draws=one_draws))
    ranks = W.PL.spawn(W.imitation_epoch, DP, args=(case,), device="cpu", timeout_s=120.0)
    return request.param, jagent, jts1, jm, one, ranks, init_params


def test_rollout_matches_one_process_and_jax(epoch):
    """The rollout is the same envs stepped on the same draws: its metrics
    over both ranks equal the one-process port's and the JAX mesh epoch's to
    1e-5 relative, and every rank reports the same global values."""
    _, _, _, jm, one, ranks, _ = epoch
    for k in ROLLOUT:
        got = ranks[0]["metrics"][k]
        assert ranks[1]["metrics"][k] == got, k
        np.testing.assert_allclose(got, one["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got, jm[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_update_metrics_match_jax(epoch):
    """The losses, kl and clip fraction are global means over the ranks'
    minibatches (the shards' own under local SGD), as the JAX epoch's; the
    tolerances are `tests/test_torch_epoch.py`'s."""
    _, _, _, jm, _, ranks, _ = epoch
    atol = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5, "clip_frac": 1e-6,
            "lr": 0.0}
    assert set(ranks[0]["metrics"]) == set(jm)
    for k, v in atol.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], jm[k], atol=v, rtol=1e-4, err_msg=k)


def _update_within(got, want, init, n_steps, what):
    """`tests/test_torch_epoch.py`'s bound: every element within 2·steps·lr,
    the whole update within 10% in norm."""
    diff2 = ref2 = 0.0
    for k, w in want.items():
        g = got[k].numpy()
        np.testing.assert_allclose(g, w, atol=2 * n_steps * LR, err_msg=f"{what} {k}")
        diff2 += float((((g - init[k]) - (w - init[k])) ** 2).sum())
        ref2 += float(((w - init[k]) ** 2).sum())
    assert ref2 > 0.0
    assert np.sqrt(diff2) <= 0.1 * np.sqrt(ref2), (what, np.sqrt(diff2), np.sqrt(ref2))


def test_params_match_jax_and_ranks_agree(epoch):
    """After the epoch every rank holds the same params, Adam moments and
    step count, bit for bit, with JAX's optimizer-step count; the params
    match the JAX mesh epoch's within `tests/test_torch_epoch.py`'s bound."""
    name, jagent, jts1, _, _, ranks, init = epoch
    r0, r1 = ranks
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for a, b in zip(r0["mu"] + r0["nu"], r1["mu"] + r1["nu"]):
        assert torch.equal(a, b)
    assert r0["count"] == r1["count"] == int(jts1.opt_state[1].count)
    assert r0["num_minibatches"] == jagent.num_minibatches
    n_steps = MINI_EPOCHS * jagent.num_minibatches
    want = {k: v.numpy() for k, v in CK.params_from_jax(_flatten(jts1.params)).items()}
    _update_within(r0["params"], want, {k: v.numpy() for k, v in init.items()}, n_steps, name)


def test_global_minibatch_equals_one_process(epoch):
    """`per_minibatch`: each optimizer step sees the global minibatch (the
    union of the shards' rows, the alive-masked mean over all of them), so
    two ranks train what one process trains on the union minibatches. Only
    the order of the sums differs: an element whose gradient is float noise
    still moves by up to lr a step either way (`tests/test_torch_epoch.py`),
    so each element is held to 2·steps·lr and the whole update to 1% of its
    norm. The running obs norm, merged across the ranks, equals the one
    process's to 1e-6 relative in both cases (under local SGD the shards
    train apart, on the same global statistics)."""
    name, jagent, _, _, one, ranks, init = epoch
    n, mean, var = ranks[0]["obs_norm"]
    assert n == one["obs_norm"][0]
    torch.testing.assert_close(mean, one["obs_norm"][1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, one["obs_norm"][2], rtol=1e-5, atol=1e-6)
    if name != "per_minibatch":
        return
    n_steps = MINI_EPOCHS * jagent.num_minibatches
    diff2 = ref2 = 0.0
    for k, v in one["params"].items():
        g, w, i = ranks[0]["params"][k].numpy(), v.numpy(), init[k].numpy()
        np.testing.assert_allclose(g, w, atol=2 * n_steps * LR, err_msg=k)
        diff2 += float(((g - w) ** 2).sum())
        ref2 += float(((w - i) ** 2).sum())
    assert np.sqrt(diff2) <= 0.01 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))


def test_moments_match_jax(epoch):
    """Both Adam moments after the epoch (under local SGD averaged with the
    params after each mini-epoch) equal the JAX mesh epoch's within 10% of
    their norm, leaf by leaf: the moments start at zero, so this is the
    bound on the update's norm above."""
    _, _, jts1, _, _, ranks, _ = epoch
    adam = jts1.opt_state[1]
    for which, got in (("mu", ranks[0]["mu"]), ("nu", ranks[0]["nu"])):
        want = CK.params_from_jax(_flatten(getattr(adam, which)))
        for k, g in zip(ranks[0]["params"], got):
            w = want[k].numpy()
            assert np.linalg.norm(g.numpy() - w) <= 0.1 * np.linalg.norm(w) + 1e-12, (which, k)
