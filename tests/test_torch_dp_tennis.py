"""`V2PPPO` over two gloo ranks on the CPU: the stage-1 epoch against the JAX
learner's over a 2-device CPU mesh, the dual rally against the port's own
one-process epoch, and the per-rank lane rules.

Stage 1 is `tests/test_torch_v2p.py`'s case (4 envs, 2 per rank; horizon 4;
a global minibatch of 8, 4 rows per shard; 2 mini-epochs; the adaptive lr;
the full-width frozen pi_low), one JAX jit compile of the mesh epoch. The
ranks get the JAX key chain's draws, global (the action noise, the env's
per-step draws) or one permutation per shard, and the JAX initial env state
(each rank its block). The dual rally (`nadal_federer`'s two identities at
test widths, two policies, `minibatch_per_chip`) runs from the port's
generators: one process and two ranks draw the same global values.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers as W
from test_torch_tennis import _port_spec, _state_arrays
from test_torch_tennis_env import make_shared, step_draws
from vid2player3d_tpu import parallel as JPL
from vid2player3d_tpu.envs import TennisConfig as JCfg
from vid2player3d_tpu.envs import TennisEnv as JEnv
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch import parallel as PL
from vid2player3d_torch.envs import DualTennisEnv, TennisConfig, TennisEnv
from vid2player3d_torch.learn import FrozenImitator, V2PConfig, V2PPPO
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import BallParams, TennisBallGenerator
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, DP = 4, 4, 8, 2, 3, 2
ENV = dict(num_envs=N, substeps=2, max_episode_length=40, reset_reaction_nframes=6,
           reward_type="return", use_random_ball_target="discrete")
LEARNER = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS, actor_units=(64, 32),
               critic_units=(64, 32), aux_dof_res_coef=0.01, lr_schedule="adaptive",
               compute_dtype="f32")
ROLLOUT = ("reward_mean", "episode_return", "done_rate", "pos_reward", "cycles", "hit_rate",
           "contact_rate", "racket_ball_dist", "racket_ball_dist_p90")


def _draws(jagent, jts):
    """The JAX mesh epoch's key splits as explicit draws (`tests/test_torch_
    v2p.py`'s, with one permutation per shard)."""
    cfg, env = jagent.cfg, jagent.env
    _, k_roll, k_shuffle, _ = jax.random.split(jts.key, 4)
    noise, env_draws = [], []
    # the state's key is laid out over the mesh like the per-env leaves; its
    # value, on one device
    key, env_key = k_roll, jax.numpy.asarray(np.asarray(jts.env_state.key))
    for _ in range(cfg.horizon):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
        env_draws.append(step_draws(env, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T // DP))(
        jax.random.split(k, DP))) for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    return {"noise": np.stack(noise), "perms": np.stack(perms), "env": env_draws}


@pytest.fixture(scope="module")
def jmesh():
    return JPL.data_parallel_mesh(DP, devices=jax.devices("cpu"))


@pytest.fixture(scope="module")
def stage1(jmesh):
    jspec, feats, jgen, jfrozen, tfrozen = make_shared()
    pi_low, pi_params = jfrozen.as_pi_low()
    jenv = JEnv(JCfg(**ENV), jspec, feats, ball_generator=jgen, pi_low=pi_low,
                pi_low_params=pi_params).shard(jmesh)
    jagent = JV2P(jenv, JV2PCfg(**LEARNER), seed=SEED, mesh=jmesh)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    case = dict(env=ENV, spec=_port_spec(jspec), feats=feats,
                pool=CK.ball_pool_from_jax(jgen, device="cpu"),
                env_kw={"pi_low": tfrozen.as_pi_low()}, learner=LEARNER, seed=SEED,
                params=init_params, env_state=_state_arrays(jts0.env_state),
                last_obs=np.asarray(jts0.last_obs), draws=draws)
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}
    one_draws = dict(draws, perms=np.stack([W.interleaved_perm(p, MB // DP)
                                            for p in draws["perms"]]))
    one = W.tennis_epoch(None, dict(case, draws=one_draws))
    ranks = PL.spawn(W.tennis_epoch, DP, args=(case,), device="cpu", timeout_s=120.0)
    return jagent, jts1, jm, one, ranks, init_params


def test_stage1_rollout_matches_one_process_and_jax(stage1):
    """The stage-1 rollout over both ranks (every behavioral metric, the
    racket-ball quantiles of both ranks' frames included) equals the
    one-process port's and the JAX mesh epoch's to 1e-5 relative; both
    ranks report the same global values; no update was skipped."""
    _, _, jm, one, ranks, _ = stage1
    for k in ROLLOUT:
        got = ranks[0]["metrics"][k]
        assert ranks[1]["metrics"][k] == got, k
        np.testing.assert_allclose(got, one["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got, jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert ranks[0]["metrics"]["grad_skip"] == jm["grad_skip"] == 0.0


def test_stage1_params_match_jax(stage1):
    """After the epoch both ranks hold the same params, moments and step
    count bit for bit; the params match the JAX mesh epoch's at
    `tests/test_torch_v2p.py`'s tolerance (2e-6 elementwise, the update to
    1e-3 of its norm) and so do the one-process port's on the union
    minibatches; the running norms are the global batch's."""
    jagent, jts1, jm, one, ranks, init = stage1
    r0, r1 = ranks
    for k in r0["params"]:
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for a, b in zip(r0["mu"] + r0["nu"], r1["mu"] + r1["nu"]):
        assert torch.equal(a, b)
    assert r0["count"] == r1["count"] == MINI_EPOCHS * jagent.num_minibatches
    assert r0["num_minibatches"] == jagent.num_minibatches
    jp = CK.params_from_jax(_flatten(jts1.params))
    for want in ({k: v.numpy() for k, v in jp.items()},
                 {k: v.numpy() for k, v in one["params"].items()}):
        diff2 = ref2 = 0.0
        for k, w in want.items():
            g = r0["params"][k].numpy()
            np.testing.assert_allclose(g, w, atol=2e-6, err_msg=k)
            diff2 += float(((g - w) ** 2).sum())
            ref2 += float(((w - init[k].numpy()) ** 2).sum())
        assert ref2 > 0.0 and np.sqrt(diff2) <= 1e-3 * np.sqrt(ref2), (diff2, ref2)
    for name in ("obs_norm", "val_norm"):
        j, (n, mean, var) = getattr(jts1, name), r0[name]
        assert n == float(j.n)
        np.testing.assert_allclose(mean.numpy(), np.asarray(j.mean), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(var.numpy(), np.asarray(j.var), atol=1e-4, rtol=1e-4)
    for r in range(DP):
        np.testing.assert_allclose(ranks[r]["last_obs"].numpy(),
                                   W.rows(np.asarray(jts1.last_obs), r), atol=1e-4)


def _dual_case():
    spec = P.make_random_spec(0, hidden=32, experts=2, device="cpu")
    nadal = dataclasses.replace(P.make_random_spec(1, player="nadal", hidden=32, experts=2,
                                                   device="cpu"), righthand=False)
    feats = (np.random.default_rng(0).standard_normal((16, P.FRAME_SIZE)) * 0.05
             ).astype(np.float32)
    feats[:, 2] = 0.95
    zero = FrozenImitator.zeros(device="cpu").as_pi_low()
    return dict(dual=True, env=dict(num_envs=N, substeps=2, reset_candidates=0,
                                    max_episode_length=3, two_hand_iters=2),
                spec=(nadal, spec), feats=(feats, feats),
                pool=TennisBallGenerator(num_candidates=256, device="cpu"),
                env_kw=dict(pi_low=zero, pi_low_b=zero, two_hand_lanes=(True, False)),
                learner=dict(horizon=T, minibatch_size=4, mini_epochs=MINI_EPOCHS,
                             num_policies=2, minibatch_per_chip=True, actor_units=(32,),
                             critic_units=(32,)), seed=2)


def test_dual_rally_per_chip_minibatches(stage1, jmesh):
    """The dual rally over two ranks (each rank one pair of lanes; per-rank
    minibatches of 4): its rollout equals the one-process epoch's to 1e-5
    relative (rallies end and the serves reset inside the horizon), every
    metric is finite, no update is skipped, the ranks hold the same
    two-policy params, and the optimizer steps per mini-epoch are JAX's for
    the same layout."""
    jagent = stage1[0]
    case = _dual_case()
    one, ranks = W.run(W.tennis_epoch, case)
    m = ranks[0]["metrics"]
    assert m["done_rate"] > 0.0
    for k in ("reward_mean", "episode_return", "done_rate", "racket_ball_dist",
              "racket_ball_dist_p90"):
        np.testing.assert_allclose(m[k], one["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert all(np.isfinite(v) for v in m.values()) and m["grad_skip"] == 0.0
    for k in ranks[0]["params"]:
        assert ranks[0]["params"][k].shape[0] == 2
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]), k
    jdual = JV2P(jagent.env, JV2PCfg(**dict(case["learner"], compute_dtype="f32")), seed=2,
                 mesh=jmesh)
    assert ranks[0]["num_minibatches"] == jdual.num_minibatches == (N * T // DP) // 4


def test_domain_randomization_over_ranks():
    """Stage 1 under domain randomization (per-env joint offsets, the ball's
    restitution, action and obs noise, from epoch 400 so the schedules are
    on) with 2 candidate resets and episodes of 3 steps: every rank draws the
    global perturbations and keeps its block, and the candidate resets take
    the global first envs' perturbed model. Two ranks' rollout equals one
    process's to 1e-5 relative, each rank's epoch model is its rows of the
    one-process model, and the ball constants are the same."""
    from vid2player3d_torch.envs.domain_rand import RandSpec

    case = _dual_case()
    case.update(dual=False, spec=case["spec"][1], feats=case["feats"][1], seed=4, epoch=400,
                env_kw=dict(pi_low=case["env_kw"]["pi_low"]),
                env=dict(num_envs=N, substeps=2, reset_candidates=2, max_episode_length=3,
                         rand_specs=(RandSpec("joint_pos", "uniform", (0.9, 1.1),
                                              schedule="linear", schedule_steps=3000),
                                     RandSpec("ball_restitution", "uniform", (0.95, 1.05)),
                                     RandSpec("actions", "gaussian", (0.0, 0.01)),
                                     RandSpec("observations", "gaussian", (0.0, 0.002)))),
                learner=dict(horizon=T, minibatch_size=MB, mini_epochs=1, actor_units=(32,),
                             critic_units=(32,)))
    one, ranks = W.run(W.tennis_epoch, case)
    assert one["metrics"]["done_rate"] > 0.0
    for k in ROLLOUT:
        np.testing.assert_allclose(ranks[0]["metrics"][k], one["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for r in range(DP):
        np.testing.assert_array_equal(ranks[r]["joint_pos"].numpy(),
                                      W.rows(one["joint_pos"].numpy(), r))
        assert ranks[r]["ball_params"] == one["ball_params"]
    assert one["ball_params"]["restitution"] != BallParams().restitution


def test_lanes_stay_inside_a_rank():
    """A rank's envs must hold whole lanes: an odd count per rank of a dual
    rally raises, and so do two lanes or two policies over one env per
    rank."""
    two = PL.DataParallelMesh(dp=2, rank=0, device=torch.device("cpu"))
    case = _dual_case()
    with pytest.raises(ValueError, match="even count"):
        DualTennisEnv(TennisConfig(**dict(case["env"], num_envs=6)), case["spec"],
                      case["feats"], ball_generator=case["pool"], device="cpu",
                      **case["env_kw"]).shard(two)
    spec, feats = case["spec"][1], case["feats"][0]
    with pytest.raises(ValueError, match="lanes"):
        TennisEnv(TennisConfig(num_envs=2, substeps=1), (spec, spec), feats,
                  ball_generator=case["pool"], device="cpu").shard(two)
    env = TennisEnv(TennisConfig(num_envs=2, substeps=1), spec, feats,
                    ball_generator=case["pool"], device="cpu").shard(two)
    with pytest.raises(ValueError, match="policy lanes"):
        V2PPPO(env, V2PConfig(horizon=4, minibatch_size=4, num_policies=2, actor_units=(8,),
                              critic_units=(8,)), mesh=two)
