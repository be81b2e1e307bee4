"""The port's dual-player rally against the JAX package's: the hand-off's
`estimate_in`, `DualTennisEnv` (reset, six steps, the hand-off and the
netted shot), the two-hand fix on mixed handedness, a single-player env with
the two-hand backhand, and one lane-routed `V2PPPO(num_policies=2)` epoch,
eager and staged as the card replays it from CUDA graphs.

The rally pairs two player identities as `nadal_federer` does: lane 0 a
left-handed nadal with the two-hand backhand, lane 1 a right-handed federer,
each with its own MVAE (hidden 32, 2 experts), init frames (8 and 6: the env
trims them to 6) and full-width frozen π_low. The env runs the stage-3 dual
flags (wrist reaction force, ball-body contact, return_w_estimate,
continuous targets, the full masked reset) at 4 envs and 6 substeps. The
JAX step, reset and epoch are jitted once per configuration in module-scope
fixtures; the port is fed the draws the JAX functions split off their keys
(`dual_reset_draws`, `dual_step_draws`). All f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tennis import _port_spec, _state_arrays, _t
from test_torch_tennis_env import _compare_out, _doctor
from vid2player3d_tpu.envs import DualTennisEnv as JDual
from vid2player3d_tpu.envs import TennisConfig as JCfg
from vid2player3d_tpu.envs import TennisEnv as JEnv
from vid2player3d_tpu.learn import FrozenImitator as JFrozen
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.learn import running_norm as JRN
from vid2player3d_tpu.learn.networks import ImitatorNet as JImitatorNet
from vid2player3d_tpu.tennis import ball as JB
from vid2player3d_tpu.tennis import player as JP
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.envs import DualTennisEnv, TennisConfig, TennisEnv
from vid2player3d_torch.learn import FrozenImitator, V2PConfig, V2PPPO
from vid2player3d_torch.learn import running_norm as RN
from vid2player3d_torch.learn.networks import ImitatorNet
from vid2player3d_torch.tennis import ball as B
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N = 4
DUAL = dict(num_envs=N, substeps=6, max_episode_length=50, ball_reaction_force=True,
            ball_body_contact=True, reward_type="return_w_estimate",
            use_random_ball_target="continuous", reset_candidates=0, two_hand_iters=8)
LANES_TWO_HAND = (True, False)


# -- the hand-off estimate ------------------------------------------------------

def test_estimate_in_matches():
    """`estimate_in` on 128 seeded outgoing ball states (13 floats, spin as
    an angular-velocity vector, top- and backspin): the mirrored in-states
    and the re-packed out-states to 1e-5, the 100-frame incoming
    trajectory to 2e-4 (400 Euler substeps, as `simulate_flight`)."""
    rng = np.random.default_rng(3)
    n = 128
    pos = rng.uniform([-4.0, -13.0, 0.5], [4.0, -10.0, 2.0], (n, 3)).astype(np.float32)
    vel = rng.uniform([-3.0, 15.0, 0.0], [3.0, 30.0, 8.0], (n, 3)).astype(np.float32)
    vspin = rng.uniform(-10.0, 10.0, n).astype(np.float32)
    spin = np.asarray(JB.spin_vector(jnp.asarray(vel), jnp.asarray(vspin)))
    st = np.concatenate([pos, np.tile([0, 0, 0, 1], (n, 1)), vel, spin], 1).astype(np.float32)
    got = B.estimate_in(_t(st), traj_length=100)
    want = JB.estimate_in(jnp.asarray(st), traj_length=100)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-4, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), st, atol=1e-5)
    np.testing.assert_allclose(got[1][:, :2].numpy(), -st[:, :2])


# -- the two envs ---------------------------------------------------------------

def _pi_low(seed, rng):
    """A full-width frozen π_low (ImitatorNet.init) with a non-trivial obs
    normalizer, in both packages."""
    jnet = JImitatorNet(num_actions=75)
    jparams = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 734)))
    mean = (rng.standard_normal(734) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 734).astype(np.float32)
    jfrozen = JFrozen(net=jnet, params=jparams, obs_norm=JRN.RunningNormState(
        n=jnp.asarray(10.0), mean=jnp.asarray(mean), var=jnp.asarray(var)))
    tnet = ImitatorNet(num_actions=75)
    tnet.load_state_dict(CK.params_from_jax(_flatten(jparams)))
    tfrozen = FrozenImitator(net=tnet, obs_norm=RN.RunningNormState(
        n=torch.tensor(10.0), mean=_t(mean), var=_t(var)))
    return jfrozen.as_pi_low(), tfrozen.as_pi_low()


def make_players():
    """Both lanes' players: (JAX specs, init sets, JAX π_low pairs, port
    π_lows), lane 0 left-handed nadal, lane 1 right-handed federer."""
    rng = np.random.default_rng(0)
    ja = dataclasses.replace(JP.make_random_spec(jax.random.PRNGKey(0), player="nadal",
                                                 hidden=32, experts=2), righthand=False)
    jb = JP.make_random_spec(jax.random.PRNGKey(1), player="federer", hidden=32, experts=2)
    feats = []
    for k in (8, 6):
        f = (rng.standard_normal((k, P.FRAME_SIZE)) * 0.05).astype(np.float32)
        f[:, 2] = 0.95
        feats.append(f)
    (ja_pi, ta_pi), (jb_pi, tb_pi) = _pi_low(0, rng), _pi_low(1, rng)
    return (ja, jb), tuple(feats), (ja_pi, jb_pi), (ta_pi, tb_pi)


def build_dual(players, jgen, **cfg_kw):
    """(JAX DualTennisEnv, port DualTennisEnv) of one configuration."""
    (ja, jb), feats, (ja_pi, jb_pi), (ta_pi, tb_pi) = players
    jenv = JDual(JCfg(**cfg_kw), (ja, jb), feats, ball_generator=jgen,
                 pi_low=ja_pi[0], pi_low_params=ja_pi[1], pi_low_b=jb_pi[0],
                 pi_low_params_b=jb_pi[1], two_hand_lanes=LANES_TWO_HAND)
    tenv = DualTennisEnv(TennisConfig(**cfg_kw), (_port_spec(ja), _port_spec(jb)), feats,
                         ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"),
                         pi_low=ta_pi, pi_low_b=tb_pi, two_hand_lanes=LANES_TWO_HAND,
                         device="cpu")
    return jenv, tenv


def dual_reset_draws(jenv, key, n):
    """The draws `TennisEnv.reset_all` splits off `key` for n envs of L
    lanes (lane l's init rows from `fold_in(k_init, l)`, in env order), with
    the dual serve's uniforms from `fold_in(k_carry, 77)`."""
    k_init, k_xy, k_ball, k_tar, k_tt, k_carry = jax.random.split(key, 6)
    L = len(jenv._lane_specs)
    init_idx = np.empty(n, np.int64)
    for lane in range(L):
        init_idx[lane::L] = np.asarray(jax.random.randint(
            jax.random.fold_in(k_init, lane), (n // L,), 0, jenv._init_per_lane))
    shape = (n,) if jenv.cfg.use_random_ball_target == "discrete" else (n, 3)
    out = {"init_idx": init_idx,
           "root_xy_u": np.asarray(jax.random.uniform(k_xy, (n, 2))),
           "ball_idx": np.asarray(jax.random.randint(k_ball, (n,), 0, jenv.gen.pool_size)),
           "target_u": np.asarray(jax.random.uniform(k_tar, shape)),
           "tt": np.asarray(jax.random.randint(k_tt, (n,), -5, 5))}
    if isinstance(jenv, JDual):
        ks = jax.random.split(jax.random.fold_in(k_carry, 77), 3)
        out["serve_u"] = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in ks], -1)
    return out


def dual_step_draws(jenv, key):
    """The draws `TennisEnv.step` splits off the state's key: the full
    masked reset's, the random-walk latents, the reaction timer and target
    (the dual hand-off draws nothing; a single-player env also draws its
    pool sample and near-launch jitter)."""
    cfg = jenv.cfg
    _, k_reset, k_rw, k_ball, k_tar, k_tt = jax.random.split(key, 6)
    shape = (cfg.num_envs,) if cfg.use_random_ball_target == "discrete" else (cfg.num_envs, 3)
    out = {"reset": dual_reset_draws(jenv, k_reset, cfg.num_envs),
           "rw_noise": np.asarray(jax.random.normal(k_rw, (cfg.num_envs, cfg.num_latents))),
           "target_u": np.asarray(jax.random.uniform(k_tar, shape)),
           "tt": np.asarray(jax.random.randint(k_tt, (cfg.num_envs,), -5, 5))}
    if not isinstance(jenv, JDual):
        k_u, k_n = jax.random.split(k_ball)
        win = max(1, jenv.gen.pool_size // 8)
        out["ball_idx"] = np.asarray(jax.random.randint(k_u, (cfg.num_envs,), 0,
                                                        jenv.gen.pool_size))
        out["near_jitter"] = np.asarray(jax.random.randint(k_n, (cfg.num_envs,), -win // 2,
                                                           win // 2 + 1))
    return out


@pytest.fixture(scope="module")
def envs():
    """The players, the pool, and (JAX env, port env, jitted JAX reset,
    jitted JAX step) under the dual flags."""
    players = make_players()
    jgen = JB.TennisBallGenerator(num_candidates=256, seed=0, backend="jax")
    jenv, tenv = build_dual(players, jgen, **DUAL)
    return players, jgen, {"dual": (jenv, tenv, jax.jit(jenv.reset_all), jax.jit(jenv.step))}


def _strong(jstate):
    """The JAX state with every leaf a strongly typed array, as the step
    returns it (a reset's weakly typed leaves would make the jitted step
    compile a second time)."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), jstate)


def _assert_states_match(got_state, want_state, atol, exact=()):
    want, got = _state_arrays(want_state), _state_arrays(got_state)
    assert set(got) == set(want)
    for k, v in want.items():
        if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer) or k in exact:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)


def test_dual_lane_arrays(envs):
    """Per-lane handedness plumbing: wrist and free-hand ids, mirrored grip
    frames, the two-hand mask and the racket mass welded into each lane's
    own wrist, equal in both packages; the init sets trimmed to 6 frames."""
    _, _, e = envs
    jenv, tenv, _, _ = e["dual"]
    for f in ("righthand", "wrist_id", "hand_id", "free_hand_id", "two_hand_mask"):
        np.testing.assert_array_equal(getattr(tenv, f).numpy(), np.asarray(getattr(jenv, f)),
                                      err_msg=f)
    assert tenv.two_hand_mask.tolist() == [True, False, True, False]
    assert tenv.righthand.tolist() == [False, True, False, True]
    for f in ("racket_dir_c", "racket_normal_c"):
        np.testing.assert_array_equal(getattr(tenv, f).numpy(), np.asarray(getattr(jenv, f)))
    for f in ("body_mass", "body_com", "body_inertia"):
        np.testing.assert_allclose(getattr(tenv.model, f).numpy(),
                                   np.asarray(getattr(jenv.model, f)), atol=1e-6, err_msg=f)
    assert tenv._init_per_lane == jenv._init_per_lane == 6
    np.testing.assert_array_equal(tenv.init_conditions.numpy(), np.asarray(jenv.init_conditions))
    np.testing.assert_allclose(tenv.rest_joints_smpl.numpy(), np.asarray(jenv.rest_joints_smpl),
                               atol=1e-6)


def test_dual_reset_all_matches(envs):
    """`reset_all` fed the JAX reset draws: the whole state and the obs to
    1e-5. Even lanes receive (reaction), odd lanes serve (recovery): each
    server's ball leaves its racket at serve speed, and its partner's
    incoming ball is that serve mirrored through the net."""
    _, _, e = envs
    jenv, tenv, jreset, _ = e["dual"]
    key = jax.random.PRNGKey(1)
    jstate, jobs = jreset(key)
    state, obs = tenv.reset_all(dual_reset_draws(jenv, key, N))
    _assert_states_match(state, jstate, 1e-5)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5)
    assert state.tar_action.tolist() == [1, 0, 1, 0]
    bp, bv, rp = state.ball_pos.numpy(), state.ball_vel.numpy(), state.racket_pos.numpy()
    np.testing.assert_array_equal(bp[1::2], rp[1::2])
    assert (bv[1::2, 1] >= 28.0).all() and (bv[0::2, 1] <= -28.0).all()
    np.testing.assert_array_equal(bp[0::2], bp[1::2] * np.float32([-1, -1, 1]))


def test_dual_six_steps_match(envs):
    """Six steps from a copied JAX reset state with the same actions and the
    JAX draws: both lanes' MVAEs and π_lows, the two-hand fix on the
    left-handed lane (whose rows start in a backhand, so the fix applies),
    the full masked reset with its serve (env 2's pair starts done, so step
    0 resets it), the ball-body and racket contacts, the coupled dones.
    Reached: obs 3.8e-6, rewards 2e-15, the state 1.1e-4 in the racket's
    velocity (two racket positions 3e-6 apart, over 1/30 s) and 2.8e-5
    elsewhere. Held: obs, extras and rewards 1e-4 as slice 2's six steps,
    the state 3e-4; every discrete output exact."""
    _, _, e = envs
    jenv, tenv, jreset, jstep = e["dual"]
    jstate = _strong(jreset(jax.random.PRNGKey(2))[0])
    s = _state_arrays(jstate)
    swing = s["mvae/swing_type"].copy()
    swing[0::2] = 2
    jstate = _doctor(jstate, s, reset_buf=np.array([0, 0, 1, 1], np.int32))
    jstate = dataclasses.replace(jstate, mvae=dataclasses.replace(
        jstate.mvae, swing_type=jnp.asarray(swing)))
    s["mvae/swing_type"] = swing
    state = CK.tennis_state_from_jax(s)
    rng = np.random.default_rng(11)
    ik_rows = 0
    for k in range(6):
        act = (rng.standard_normal((N, jenv.num_actions)) * 0.5).astype(np.float32)
        draws = dual_step_draws(jenv, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(act))
        state, out = tenv.step(state, _t(act), draws)
        _compare_out(out, jout, f"step {k}", obs_atol=1e-4)
        d = np.asarray(jout.done)
        np.testing.assert_array_equal(d[0::2], d[1::2])
        st, ph = np.asarray(jstate.mvae.swing_type), np.asarray(jstate.mvae.phase_pred)
        ik_rows += int(((st == 2) & (ph > 2.0) & (ph < 5.0))[0::2].sum())
    assert ik_rows > 0, "the two-hand fix never applied"
    _assert_states_match(state, jstate, 3e-4)


def test_apply_two_hand_matches(envs):
    """The env's two-hand fix on mixed handedness: rows 0-3 of a reset state
    set mid-backhand (swing type 2, phase 3) except row 2 (a forehand) and
    row 3 (phase 1.0). Only row 0 is on the left-handed two-hand lane and in
    a backhand: it moves, every other row passes through bit for bit; to
    1e-5 of the JAX package's."""
    _, _, e = envs
    jenv, tenv, jreset, _ = e["dual"]
    jstate, _ = jreset(jax.random.PRNGKey(5))
    jm = dataclasses.replace(jstate.mvae, phase_pred=jnp.array([3.0, 3.0, 3.0, 1.0]),
                             swing_type=jnp.array([2, 2, 1, 2], jnp.int32))
    want = np.asarray(jax.jit(jenv._apply_two_hand)(jm).joint_rotmat)
    tm = CK.tennis_state_from_jax(_state_arrays(dataclasses.replace(jstate, mvae=jm))).mvae
    got = tenv._apply_two_hand(tm).joint_rotmat.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    before = tm.joint_rotmat.numpy()
    assert np.abs(got[0] - before[0]).max() > 0.01
    np.testing.assert_array_equal(got[1:], before[1:])


def _strike(r_prev, normal, racket_vel, v_out):
    """Ball position and velocity that leave the racket at `v_out`. The
    racket sweeps from `r_prev` at `racket_vel` with face normal `normal`
    over the step; the ball starts 0.1 m off the face on the side it
    approaches from, with the racket's velocity plus `v_out`'s part along
    the face (which the contact keeps) plus an approach speed along the
    normal that the stringbed's restitution (0.8) turns into `v_out`'s
    normal part."""
    w = v_out - racket_vel
    wn = float(w @ normal)
    side = 1.0 if wn >= 0 else -1.0
    pos = r_prev + 0.1 * side * normal
    vel = racket_vel + (w - wn * normal) - side * (abs(wn) / 0.8) * normal
    return pos.astype(np.float32), vel.astype(np.float32)


def test_handoff_and_netted_shot_match(envs):
    """One step under the dual flags from a doctored state: env 0 strikes a
    ball that clears the net and is estimated in, so its partner env 1 turns
    to reaction with that ball mirrored through the net (the hand-off
    gathers the partner's ball by the lane swap); env 2 strikes a ball down
    into its own court: its estimate is not in and the mirrored flight is
    netted, so env 3 terminates by the hand-off gate, env 2 by the estimate,
    and the coupling ends the pair. The strikes are aimed from a first,
    undoctored step (the humanoid's motion does not depend on the ball):
    the racket's new face normal and velocity. Against the JAX step fed the
    same draws: everything to 2e-4, every flag exact."""
    _, _, e = envs
    jenv, tenv, jreset, jstep = e["dual"]
    jstate = _strong(jreset(jax.random.PRNGKey(3))[0])
    act = (np.random.default_rng(12).standard_normal((N, jenv.num_actions)) * 0.1
           ).astype(np.float32)
    probe = _state_arrays(jstep(jstate, jnp.asarray(act))[0])
    s = _state_arrays(jstate)
    ball_pos, ball_vel = s["ball_pos"].copy(), s["ball_vel"].copy()
    for env, v_out in ((0, np.float32([0.0, 18.0, 7.0])), (2, np.float32([0.0, 3.0, -6.0]))):
        ball_pos[env], ball_vel[env] = _strike(s["racket_pos"][env], probe["racket_normal"][env],
                                               probe["racket_vel"][env], v_out)
    jstate = _doctor(jstate, s, ball_pos=ball_pos, ball_vel=ball_vel,
                     ball_vspin=np.zeros(N, np.float32))
    state = CK.tennis_state_from_jax(s)
    draws = dual_step_draws(jenv, jstate.key)
    jstate2, jout = jstep(jstate, jnp.asarray(act))
    state2, out = tenv.step(state, _t(act), draws)
    _compare_out(out, jout, "step", obs_atol=2e-4)
    _assert_states_match(state2, jstate2, 2e-4)
    # the cases happened: contacts on 0 and 2; env 1 in reaction with env
    # 0's ball mirrored; the netted pair done and terminated
    w = _state_arrays(jstate2)
    np.testing.assert_array_equal(np.asarray(jout.extras["contact_now"]), [1, 0, 1, 0])
    assert w["est_bounce_in"].tolist() == [True, False, False, False]
    assert w["tar_action"][1] == 1 and w["tar_time"][1] == 0
    mir = np.float32([-1, -1, 1])
    np.testing.assert_allclose(w["ball_pos"][1], w["ball_pos"][0] * mir, atol=1e-6)
    np.testing.assert_allclose(w["ball_vel"][1], w["ball_vel"][0] * mir, atol=1e-6)
    np.testing.assert_allclose(w["ball_vel"][0], [0.0, 18.0, 7.0], atol=1.0)
    assert np.asarray(jout.done).tolist() == [0, 0, 1, 1]
    assert np.asarray(jout.terminate).tolist() == [0, 0, 1, 1]
    netted = B.simulate_flight(_t(w["ball_pos"][2:3] * mir), _t(w["ball_vel"][2:3] * mir),
                               _t(w["ball_vspin"][2:3]))
    assert not bool(netted.pass_net[0])


# -- the single-player two-hand backhand (the nadal demo semantics) -------------

def test_single_player_two_hand_steps_match(envs):
    """A single-player `TennisEnv` with `two_hand_backhand=True` and the
    left-handed nadal spec (2 envs, 2 substeps, discrete targets, the full
    masked reset): three steps from a copied JAX reset state whose rows
    start in a backhand, with the JAX draws. Obs, extras and rewards 1e-4,
    the state 1e-4, every flag exact."""
    players, jgen, _ = envs
    (ja, _), (fa, _), ((pi, pp), _), (tpi, _) = players
    kw = dict(num_envs=2, substeps=2, max_episode_length=50, reset_reaction_nframes=8,
              use_random_ball_target="discrete", two_hand_backhand=True)
    jenv = JEnv(JCfg(**kw), ja, fa, ball_generator=jgen, pi_low=pi, pi_low_params=pp)
    tenv = TennisEnv(TennisConfig(**kw), _port_spec(ja), fa,
                     ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"), pi_low=tpi,
                     device="cpu")
    assert tenv.two_hand_mask.tolist() == [True, True] and tenv.righthand.tolist() == [False] * 2
    jstate = _strong(jenv.reset_all(jax.random.PRNGKey(4))[0])
    jstate = dataclasses.replace(jstate, mvae=dataclasses.replace(
        jstate.mvae, swing_type=jnp.full((2,), 2, jnp.int32)))
    state = CK.tennis_state_from_jax(_state_arrays(jstate))
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(13)
    for k in range(3):
        act = (rng.standard_normal((2, jenv.num_actions)) * 0.5).astype(np.float32)
        draws = dual_step_draws(jenv, jstate.key)
        jstate, jout = jstep(jstate, jnp.asarray(act))
        state, out = tenv.step(state, _t(act), draws)
        _compare_out(out, jout, f"step {k}", obs_atol=1e-4)
    _assert_states_match(state, jstate, 1e-4)


# -- one lane-routed epoch ------------------------------------------------------

T_H, MB, MINI_EPOCHS, SEED = 4, 8, 2, 3
LEARNER = dict(horizon=T_H, minibatch_size=MB, mini_epochs=MINI_EPOCHS, actor_units=(64, 32),
               critic_units=(64, 32), aux_dof_res_coef=0.01, compute_dtype="f32",
               num_policies=2)


def _epoch_draws(jagent, jts):
    """The JAX epoch's key splits as explicit draws (as tests/test_torch_v2p.py)."""
    cfg, env = jagent.cfg, jagent.env
    _, k_roll, k_shuffle, _ = jax.random.split(jts.key, 4)
    noise, env_draws = [], []
    key, env_key = k_roll, jts.env_state.key
    for _ in range(cfg.horizon):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, env.num_actions))))
        env_draws.append(dual_step_draws(env, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perms = [np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T_H))(
        jax.random.split(k, 1)))[0] for k in jax.random.split(k_shuffle, cfg.mini_epochs)]
    return {"noise": np.stack(noise), "perms": np.stack(perms), "env": env_draws}


@pytest.fixture(scope="module")
def epoch_start(envs):
    """The JAX `V2PPPO(num_policies=2)` agent on the dual env, its initial
    train state, that epoch's draws, and the start as the port takes it
    (params, env state arrays, last obs)."""
    _, _, e = envs
    jenv, _, _, _ = e["dual"]
    jagent = JV2P(jenv, JV2PCfg(**LEARNER), seed=SEED)
    jts0 = jagent.init_state()
    draws = _epoch_draws(jagent, jts0)
    start = (CK.params_from_jax(_flatten(jts0.params)), _state_arrays(jts0.env_state),
             np.asarray(jts0.last_obs))
    return jagent, jts0, draws, start


def _port_start(tagent, start):
    """The port's train state at the JAX epoch's start."""
    init_params, env_state0, last_obs0 = start
    ts = tagent.init_state(params=init_params)
    ts.env_state = CK.tennis_state_from_jax(env_state0)
    ts.last_obs = torch.tensor(last_obs0)
    return ts


@pytest.fixture(scope="module")
def epoch(envs, epoch_start, tmp_path_factory):
    """One JAX `V2PPPO(num_policies=2)` epoch on the dual env and the port's
    fed its draws; the JAX agent's checkpoint after it."""
    _, _, e = envs
    _, tenv, _, _ = e["dual"]
    jagent, jts0, draws, start = epoch_start
    jts1, jm = jagent.train_epoch(jts0)
    jm = {k: float(v) for k, v in jm.items()}
    path = str(tmp_path_factory.mktemp("dual") / "v2p_dual.npz")
    jagent.save_checkpoint(path, jts1)

    tagent = V2PPPO(tenv, V2PConfig(**LEARNER), seed=SEED, device="cpu")
    tts1, tm = tagent.train_epoch(_port_start(tagent, start), draws=draws)
    tm = {k: float(v) for k, v in tm.items()}
    return jts1, jm, tagent, tts1, tm, start[0], path


METRIC_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5, "lr": 1e-9}


def test_dual_epoch_metrics_match(epoch):
    """Every metric of the JAX dual epoch (slice 2's tolerances); no skipped
    update."""
    _, jm, _, _, tm, _, _ = epoch
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
    assert tm["grad_skip"] == 0.0


def test_dual_epoch_params_match(epoch):
    """The stacked params after the epoch's 4 Adam steps (one global clip
    norm over both policies): 2e-6 elementwise and 1e-3 of the update's norm
    (slice 2's bounds); both policies moved. The normalizers, the carried
    env state (1e-4) and the Adam count agree."""
    jts1, _, _, tts1, _, init_params, _ = epoch
    jp = CK.params_from_jax(_flatten(jts1.params))
    diff2 = ref2 = 0.0
    for k, v in tts1.params.items():
        got, want = v.detach().numpy(), jp[k].numpy()
        assert got.shape[0] == 2
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=k)
        diff2 += float(((got - want) ** 2).sum())
        ref2 += float(((want - init_params[k].numpy()) ** 2).sum())
    assert np.sqrt(diff2) <= 1e-3 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))
    for p in (0, 1):
        assert any(float((v.detach()[p] - init_params[k][p]).abs().max()) > 0
                   for k, v in tts1.params.items())
    assert int(tts1.opt_state.count) == MINI_EPOCHS * (N * T_H // MB)
    for name in ("obs_norm", "val_norm"):
        j, t = getattr(jts1, name), getattr(tts1, name)
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(t.var.numpy(), np.asarray(j.var), atol=1e-4, rtol=1e-4)
    _assert_states_match(tts1.env_state, jts1.env_state, 1e-4)


def test_staged_dual_epoch_matches_jax(epoch_start, epoch):
    """The port's staged dual epoch (`_train_epoch_graphed`: each env step
    and each optimizer step one `StaticGraph` call, the path the card
    replays) from the JAX epoch's start on its draws: every metric and the
    stacked params held to the JAX epoch at `test_dual_epoch_metrics_match`'s
    and `test_dual_epoch_params_match`'s bounds, and bit for bit with the
    port's eager epoch on the same draws."""
    jts1, jm, tagent, tts1, tm, init_params, _ = epoch
    _, _, draws, start = epoch_start
    ts, m = tagent._train_epoch_graphed(_port_start(tagent, start), draws=draws)
    assert (tagent._st.step.captures, tagent._st.update.captures) == (1, 1)
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], atol=METRIC_ATOL.get(k, 1e-5), rtol=1e-4,
                                   err_msg=k)
        assert m[k] == tm[k] or (np.isnan(m[k]) and np.isnan(tm[k])), k
    assert m["grad_skip"] == 0.0
    jp = CK.params_from_jax(_flatten(jts1.params))
    diff2 = ref2 = 0.0
    for k, v in ts.params.items():
        got, want = v.detach().numpy(), jp[k].numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=k)
        diff2 += float(((got - want) ** 2).sum())
        ref2 += float(((want - init_params[k].numpy()) ** 2).sum())
        assert torch.equal(v, tts1.params[k]), k
    assert np.sqrt(diff2) <= 1e-3 * np.sqrt(ref2), (np.sqrt(diff2), np.sqrt(ref2))
    assert int(ts.opt_state.count) == MINI_EPOCHS * (N * T_H // MB)
    _assert_states_match(ts.env_state, jts1.env_state, 1e-4)


def test_other_policy_gradient_is_zero(epoch):
    """On a minibatch of lane-0 samples only, every gradient of policy 1's
    slice of the stacked leaves is exactly 0, and policy 0's is not."""
    _, _, tagent, tts1, _, _, _ = epoch
    obs = torch.randn(8, tagent.obs_dim, generator=torch.Generator().manual_seed(0))
    mb = dict(obs=obs, action=torch.randn(8, tagent.num_actions), old_mu=torch.zeros(8, 35),
              old_neglogp=torch.zeros(8), adv=torch.randn(8), return_norm=torch.randn(8),
              lane=torch.zeros(8, dtype=torch.long))
    loss, _ = tagent._loss(tts1.params, mb, tts1.obs_norm)
    grads = torch.autograd.grad(loss, list(tts1.params.values()))
    assert all(bool((g[1] == 0).all()) for g in grads)
    assert any(float(g[0].abs().max()) > 0 for g in grads)


def test_dual_checkpoint_loads(epoch):
    """A JAX `V2PPPO(num_policies=2)` checkpoint (stacked leaves and Adam
    moments, leading axis 2) loads into the port's stacked leaves: params,
    both moments, the count and the normalizers exactly."""
    jts1, _, tagent, _, _, _, path = epoch
    ts = tagent.load_checkpoint(path)
    jp = CK.params_from_jax(_flatten(jts1.params))
    for k, v in ts.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), jp[k].numpy(), err_msg=k)
    mu, nu, count = CK.adam_state_from_jax(CK.load_npz(path))
    assert int(ts.opt_state.count) == count == int(jts1.opt_state[1].count)
    for k, m, v in zip(ts.params, ts.opt_state.mu, ts.opt_state.nu):
        assert m.shape[0] == 2
        np.testing.assert_array_equal(m.numpy(), mu[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(v.numpy(), nu[k].numpy(), err_msg=k)
    jmu = CK.params_from_jax(_flatten(jts1.opt_state[1].mu))
    for k, m in zip(ts.params, ts.opt_state.mu):
        np.testing.assert_array_equal(m.numpy(), jmu[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(ts.obs_norm.mean.numpy(), np.asarray(jts1.obs_norm.mean))
