"""The port's tennis env step against the JAX package's, under stage-1 and
stage-2 flags and through the masked resets (all N envs, and K candidates)
and the reaction transition.

The JAX env is built as `tests/test_tennis_env.py` builds it (2 substeps,
MVAE hidden 32 / 2 experts) with a full-width frozen π_low from
`ImitatorNet.init` and a non-trivial obs normalizer; its `reset_all` and
`step` are jitted once per configuration. The port gets the same MVAE and
π_low weights, the same ball pool and the JAX reset state, and is fed the
draws the JAX step splits off its key (`envs/tennis.py` `step`: reset,
random walk, ball, target and reaction-timer keys; `reset_all`: init, root,
ball, target and timer keys). All f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tennis import _port_spec, _state_arrays, _t
from vid2player3d_tpu.envs import TennisConfig as JCfg
from vid2player3d_tpu.envs import TennisEnv as JEnv
from vid2player3d_tpu.learn import FrozenImitator as JFrozen
from vid2player3d_tpu.learn import running_norm as JRN
from vid2player3d_tpu.learn.networks import ImitatorNet as JImitatorNet
from vid2player3d_tpu.tennis import ball as JB
from vid2player3d_tpu.tennis import player as JP
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.envs import TennisConfig, TennisEnv
from vid2player3d_torch.learn import FrozenImitator
from vid2player3d_torch.learn import running_norm as RN
from vid2player3d_torch.learn.networks import ImitatorNet
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

# stage 1's flags, plus the options no other test config drives: the serve
# toss as the initial ball, the look-at-ball head fix, the phase-synchronized
# launch gate
STAGE1 = dict(num_envs=4, substeps=2, max_episode_length=50, reset_reaction_nframes=8,
              reward_type="reach", use_random_ball_target="discrete",
              init_ball_type="serve_toss", fix_head_orientation=True, sync_launch=True)
STAGE2 = dict(num_envs=6, substeps=6, max_episode_length=50, reset_reaction_nframes=8,
              ball_reaction_force=True, ball_body_contact=True,
              reward_type="return_w_estimate", reset_candidates=2)


def make_shared():
    """The pieces both packages' envs share: MVAE spec, init frames, ball
    pool, a full-width π_low (ImitatorNet.init, seed 0) with a non-trivial
    obs normalizer."""
    jspec = JP.make_random_spec(jax.random.PRNGKey(0), hidden=32, experts=2)
    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((8, P.FRAME_SIZE)) * 0.05).astype(np.float32)
    feats[:, 2] = 0.95
    jgen = JB.TennisBallGenerator(num_candidates=256, seed=0, backend="jax")
    jnet = JImitatorNet(num_actions=75)
    jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 734)))
    mean = (rng.standard_normal(734) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 734).astype(np.float32)
    jnorm = JRN.RunningNormState(n=jnp.asarray(10.0), mean=jnp.asarray(mean),
                                 var=jnp.asarray(var))
    jfrozen = JFrozen(net=jnet, params=jparams, obs_norm=jnorm)
    tnet = ImitatorNet(num_actions=75)
    tnet.load_state_dict(CK.params_from_jax(_flatten(jparams)))
    tfrozen = FrozenImitator(net=tnet, obs_norm=RN.RunningNormState(
        n=torch.tensor(10.0), mean=_t(mean), var=_t(var)))
    return jspec, feats, jgen, jfrozen, tfrozen


def build_envs(shared, **cfg_kw):
    """(JAX env, port env) of one configuration over the shared pieces."""
    jspec, feats, jgen, jfrozen, tfrozen = shared
    pi_low, pi_params = jfrozen.as_pi_low()
    jenv = JEnv(JCfg(**cfg_kw), jspec, feats, ball_generator=jgen, pi_low=pi_low,
                pi_low_params=pi_params)
    tenv = TennisEnv(TennisConfig(**cfg_kw), _port_spec(jspec), feats,
                     ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"),
                     pi_low=tfrozen.as_pi_low(), device="cpu")
    return jenv, tenv


def reset_draws(jenv, key, n):
    """The draws `TennisEnv.reset_all` splits off `key` for n envs."""
    k_init, k_xy, k_ball, k_tar, k_tt, _ = jax.random.split(key, 6)
    shape = (n,) if jenv.cfg.use_random_ball_target == "discrete" else (n, 3)
    return {"init_idx": np.asarray(jax.random.randint(jax.random.fold_in(k_init, 0), (n,), 0,
                                                      jenv.init_conditions.shape[0])),
            "root_xy_u": np.asarray(jax.random.uniform(k_xy, (n, 2))),
            "ball_idx": np.asarray(jax.random.randint(k_ball, (n,), 0, jenv.gen.pool_size)),
            "target_u": np.asarray(jax.random.uniform(k_tar, shape)),
            "tt": np.asarray(jax.random.randint(k_tt, (n,), -5, 5))}


def step_draws(jenv, key):
    """The draws `TennisEnv.step` splits off the state's key."""
    cfg = jenv.cfg
    N = cfg.num_envs
    _, k_reset, k_rw, k_ball, k_tar, k_tt = jax.random.split(key, 6)
    K = cfg.reset_candidates
    k_u, k_n = jax.random.split(k_ball)
    win = max(1, jenv.gen.pool_size // 8)
    shape = (N,) if cfg.use_random_ball_target == "discrete" else (N, 3)
    return {"reset": reset_draws(jenv, k_reset, K if 0 < K < N else N),
            "rw_noise": np.asarray(jax.random.normal(k_rw, (N, cfg.num_latents))),
            "ball_idx": np.asarray(jax.random.randint(k_u, (N,), 0, jenv.gen.pool_size)),
            "near_jitter": np.asarray(jax.random.randint(k_n, (N,), -win // 2, win // 2 + 1)),
            "target_u": np.asarray(jax.random.uniform(k_tar, shape)),
            "tt": np.asarray(jax.random.randint(k_tt, (N,), -5, 5))}


@pytest.fixture(scope="module")
def configs():
    """Per configuration: (JAX env, port env, jitted JAX reset, jitted JAX
    step), built once for the module."""
    shared = make_shared()
    out = {}
    for name, kw in (("stage1", STAGE1), ("stage2", STAGE2)):
        jenv, tenv = build_envs(shared, **kw)
        out[name] = (jenv, tenv, jax.jit(jenv.reset_all), jax.jit(jenv.step))
    return shared, out


def _compare_out(got, want, step, obs_atol):
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done), err_msg=step)
    np.testing.assert_array_equal(got.terminate.numpy(), np.asarray(want.terminate),
                                  err_msg=step)
    assert set(got.extras) == set(want.extras)
    for k, v in want.extras.items():
        np.testing.assert_allclose(got.extras[k].numpy(), np.asarray(v), atol=obs_atol,
                                   err_msg=f"{step} {k}")
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(want.reward), atol=1e-5,
                               err_msg=step)
    np.testing.assert_allclose(got.sub_rewards.numpy(), np.asarray(want.sub_rewards),
                               atol=1e-5, err_msg=step)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), atol=obs_atol,
                               err_msg=step)


def _doctor(jstate, s, **fields):
    """Set fields (numpy) in both the JAX state and its copied arrays."""
    s.update(fields)
    return dataclasses.replace(jstate, **{k: jnp.asarray(v) for k, v in fields.items()})


def test_reset_all_matches(configs):
    """`reset_all` fed the JAX reset draws: the whole state and the obs.
    The humanoid is snapped to the FK pose (K3's plain version) through
    quaternion round trips: 1e-5."""
    _, envs = configs
    jenv, tenv, jreset, _ = envs["stage1"]
    key = jax.random.PRNGKey(1)
    jstate, jobs = jreset(key)
    state, obs = tenv.reset_all(reset_draws(jenv, key, jenv.cfg.num_envs))
    want, got = _state_arrays(jstate), _state_arrays(state)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5)


@pytest.mark.parametrize("flags", ["stage1", "stage2"])
def test_six_steps_match(configs, flags):
    """From the copied JAX reset state, six steps with the same actions and
    the JAX draws. stage1: 4 envs, 2 substeps, reach reward, discrete
    targets, the serve toss, the head fix and the synchronized launch gate,
    the full masked reset (env 2 starts done, so step 0 resets it); stage2: 6 envs, 6 substeps, wrist reaction force, ball-body
    contact, return_w_estimate, K = 2 candidate resets.

    The stiff stable-PD ABA amplifies one-ulp differences from step to step
    (tests/test_torch_env.py), but here the humanoid tracks smooth MVAE
    targets and the differences stay small. Reached over the six steps:
    obs 6.2e-6 (stage 1) and 4.1e-6 (stage 2), reward 0, racket-ball
    distance 3.8e-6; reactions fire in both runs. Held: obs, extras and
    rewards 1e-4, root position 1e-4; every discrete output (done,
    terminate, cycle and contact flags, the task machine) exact."""
    _, envs = configs
    jenv, tenv, jreset, jstep = envs[flags]
    N = jenv.cfg.num_envs
    jstate, _ = jreset(jax.random.PRNGKey(2))
    s = _state_arrays(jstate)
    if flags == "stage1":
        jstate = _doctor(jstate, s, reset_buf=np.array([0, 0, 1, 0], np.int32))
    state = CK.tennis_state_from_jax(s)
    rng = np.random.default_rng(11)
    for k in range(6):
        act = (rng.standard_normal((N, jenv.num_actions)) * 0.5).astype(np.float32)
        draws = step_draws(jenv, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(act))
        state, out = tenv.step(state, _t(act), draws)
        _compare_out(out, jout, f"step {k}", obs_atol=1e-4)
    want, got = _state_arrays(jstate), _state_arrays(state)
    for k in ("tar_action", "tar_time", "tar_time_total", "progress", "reset_buf",
              "has_contact", "mvae/swing_type"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ball_pos"], want["ball_pos"], atol=1e-4)
    np.testing.assert_allclose(got["sim/root_pos"], want["sim/root_pos"], atol=1e-4)


def test_candidate_reset_reaction_and_contact_step_matches(configs):
    """One stage-2 step (K = 2 candidates) from a doctored state:
    - envs 0, 2 and 5 are done: the two candidate resets go to slots 0 and
      1, and env 5, past K, reuses slot 1;
    - env 1 is in recovery (random-walk latents) and hits its reaction
      timer with the ball on this side (a plain pool launch);
    - env 3 hits its timer with the ball on the far side (a launch near
      where it is);
    - env 4's ball sits in front of the racket head flying at it: a racket
      contact, its impulse, the outgoing-bounce estimate.
    The JAX draws are fed in; after one step everything agrees to 2e-4,
    every flag and counter exactly."""
    _, envs = configs
    jenv, tenv, jreset, jstep = envs["stage2"]
    jstate, _ = jreset(jax.random.PRNGKey(3))
    s = _state_arrays(jstate)
    ball_pos, ball_vel = s["ball_pos"].copy(), s["ball_vel"].copy()
    ball_pos[1] = (0.5, -6.0, 1.0)
    n4 = s["racket_normal"][4]
    ball_pos[4] = s["racket_pos"][4] + 0.2 * n4
    ball_vel[4] = -15.0 * n4
    jstate = _doctor(jstate, s, reset_buf=np.array([1, 0, 1, 0, 0, 1], np.int32),
                     tar_action=np.array([1, 0, 1, 1, 1, 1], np.int32),
                     tar_time_total=np.array([50, 1, 50, 1, 50, 50], np.int32),
                     ball_pos=ball_pos, ball_vel=ball_vel)
    state = CK.tennis_state_from_jax(s)
    act = (np.random.default_rng(12).standard_normal((6, jenv.num_actions)) * 0.5
           ).astype(np.float32)
    draws = step_draws(jenv, jstate.key)
    jstate2, jout = jstep(jstate, jnp.asarray(act))
    state2, out = tenv.step(state, _t(act), draws)
    _compare_out(out, jout, "step", obs_atol=2e-4)
    want, got = _state_arrays(jstate2), _state_arrays(state2)
    assert set(got) == set(want)
    # the cases happened: three resets, reactions in 1 and 3, a contact in 4
    np.testing.assert_array_equal(want["progress"], np.ones(6))
    assert (want["tar_time"][[1, 3]] == 0).all() and (want["tar_action"][[1, 3]] == 1).all()
    assert bool(np.asarray(jout.extras["contact_now"])[4])
    for k, v in want.items():
        if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=2e-4, err_msg=k)


def test_unported_tennis_options_raise(configs):
    """Domain randomization now builds (its parity is in
    tests/test_torch_dr_tennis.py; an unknown target raises), as do the
    two-hand backhand and one spec per lane (tests/test_torch_twohand.py,
    tests/test_torch_dual.py); lanes that do not divide the envs, or init
    sets that do not match the lanes, raise."""
    from vid2player3d_torch.envs.domain_rand import RandSpec

    shared, _ = configs
    jspec, feats, jgen, _, _ = shared
    spec = _port_spec(jspec)
    gen = CK.ball_pool_from_jax(jgen, device="cpu")
    env = TennisEnv(TennisConfig(num_envs=2, rand_specs=(RandSpec("kp", "uniform", (0.9, 1.1)),)),
                    spec, feats, ball_generator=gen, device="cpu")
    assert env.with_model(env.randomizer.randomize_model(env.model)).model is not env.model
    with pytest.raises(ValueError):
        TennisEnv(TennisConfig(num_envs=2, rand_specs=(RandSpec("ball_bogus"),)), spec, feats,
                  ball_generator=gen, device="cpu")
    assert TennisEnv(TennisConfig(num_envs=2, two_hand_backhand=True), spec, feats,
                     ball_generator=gen, device="cpu").any_two_hand
    env = TennisEnv(TennisConfig(num_envs=2), (spec, spec), feats, ball_generator=gen,
                    device="cpu")
    assert env.two_hand_mask.tolist() == [False, False]
    with pytest.raises(ValueError):
        TennisEnv(TennisConfig(num_envs=3), (spec, spec), feats, ball_generator=gen,
                  device="cpu")
    with pytest.raises(ValueError):
        TennisEnv(TennisConfig(num_envs=2), (spec, spec), (feats,), ball_generator=gen,
                  device="cpu")
