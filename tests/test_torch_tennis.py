"""The port's tennis pieces against the JAX package: ball flight and the
outgoing-bounce estimate, the ball pool's gathers and the MVAE player; and
the helpers that copy JAX tennis states, specs and pools into the port
(shared with tests/test_torch_tennis_env.py and tests/test_torch_v2p.py).
All f32 on the CPU, inputs made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.tennis import ball as JB
from vid2player3d_tpu.tennis import player as JP
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.mvae.model import PoseMixtureVAE
from vid2player3d_torch.tennis import ball as B
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


# -- ball -----------------------------------------------------------------------

def _launches(n, seed):
    """Seeded launches from the opponent's side, as the pool draws them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-4.0, 12.0, 1.0], [4.0, 13.0, 1.5], (n, 3))
    tgt = rng.uniform([-3.0, -10.0], [3.0, -7.0], (n, 2))
    d = tgt - pos[:, :2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    speed = rng.uniform(20.0, 32.0, n)
    theta = np.deg2rad(rng.uniform(2.0, 18.0, n))
    vel = np.stack([speed * np.cos(theta) * d[:, 0], speed * np.cos(theta) * d[:, 1],
                    speed * np.sin(theta)], 1)
    vspin = rng.uniform(-10.0, 10.0, n)
    return pos.astype(np.float32), vel.astype(np.float32), vspin.astype(np.float32)


def test_aero_force_matches():
    """Drag + Magnus on 256 seeded velocities with top- and backspin: the
    same f32 formula, 1e-5 relative."""
    _, vel, vspin = _launches(256, 0)
    got = B.aero_force(_t(vel), _t(vspin)).numpy()
    want = np.asarray(JB.aero_force(jnp.asarray(vel), jnp.asarray(vspin)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_simulate_flight_matches():
    """100 frames x 4 substeps of 128 seeded launches. Every bounce and net
    flag agrees; positions after 400 Euler substeps agree to 2e-4 m (f32
    rounding of a ~20 m flight, summed in another order)."""
    pos, vel, vspin = _launches(128, 1)
    got = B.simulate_flight(_t(pos), _t(vel), _t(vspin), num_frames=100, substeps=4)
    want = JB.simulate_flight(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(vspin),
                              num_frames=100, substeps=4)
    for f in ("has_bounce", "pass_net", "bounce_frame"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.has_bounce.any() and got.pass_net.any() and not got.pass_net.all()
    for f, atol in (("traj", 2e-4), ("bounce_pos", 2e-4), ("bounce_time", 1e-6),
                    ("max_height_after_bounce", 2e-4), ("final_pos", 2e-4),
                    ("final_vel", 2e-4), ("final_vspin", 1e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=atol, rtol=1e-5, err_msg=f)


def test_estimate_out_matches():
    """The outgoing-bounce estimate (90 frames, 1 substep) of 128 seeded
    post-contact ball states (13-dim, spin as an angular-velocity vector):
    validity exact, bounce position, time and max height to 2e-4."""
    pos, vel, vspin = _launches(128, 2)
    pos = pos * np.float32([1.0, -1.0, 1.0])        # now on this side, going out
    pos[:, 1] += 1.0
    vel = vel * np.float32([-1.0, -1.0, 1.0])
    spin = np.asarray(JB.spin_vector(jnp.asarray(vel), jnp.asarray(vspin)))
    np.testing.assert_allclose(B.spin_vector(_t(vel), _t(vspin)).numpy(), spin, atol=1e-5)
    st = np.concatenate([pos, np.tile([0, 0, 0, 1], (128, 1)), vel, spin], 1).astype(np.float32)
    got = B.estimate_out(_t(st), num_frames=90)
    want = JB.estimate_out(jnp.asarray(st), num_frames=90)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any() and not got[0].all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def pools():
    jgen = JB.TennisBallGenerator(num_candidates=256, seed=0, backend="jax")
    return jgen, CK.ball_pool_from_jax(jgen, device="cpu")


def test_ball_pool_gathers_match(pools):
    """`from_arrays` over the JAX pool; `sample` and `sample_near` fed the
    indices and jitters the JAX generator draws from its keys gather the
    same rows (side-left searchsorted on the same sorted launch x)."""
    jgen, tgen = pools
    assert tgen.pool_size == jgen.pool_size
    np.testing.assert_array_equal(tgen.x_order.numpy(), np.asarray(jgen.x_order))
    key = jax.random.PRNGKey(5)
    idx = np.asarray(jax.random.randint(key, (16,), 0, jgen.pool_size))
    for g, w in zip(tgen.sample(16, idx=idx), jgen.sample(key, 16)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = np.random.default_rng(6).uniform(-5.0, 5.0, 16).astype(np.float32)
    win = max(1, jgen.pool_size // 8)
    jitter = np.asarray(jax.random.randint(key, (16,), -win // 2, win // 2 + 1))
    for g, w in zip(tgen.sample_near(_t(x), jitter=jitter), jgen.sample_near(key, jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ball_generator_makes_a_valid_pool():
    """The port's own pool (its own seeded draws): every kept trajectory
    clears the net and bounces inside the box, as the filter demands. The
    native backend flies the same draws on the host: its kept launches
    clear the net and bounce in the device integrator too."""
    gen = B.TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    assert 0 < gen.pool_size <= 256
    res = B.simulate_flight(gen.launch_pos, gen.launch_vel, gen.launch_vspin,
                            num_frames=gen.traj_length)
    assert bool(res.pass_net.all()) and bool(res.has_bounce.all())
    torch.testing.assert_close(res.traj, gen.traj_pool, rtol=0.0, atol=0.0)
    nat = B.TennisBallGenerator(num_candidates=256, seed=0, backend="native", device="cpu")
    assert nat.backend == "native" and 0 < nat.pool_size <= 256
    res = B.simulate_flight(nat.launch_pos, nat.launch_vel, nat.launch_vspin,
                            num_frames=nat.traj_length)
    assert bool(res.has_bounce.all())
    torch.testing.assert_close(res.traj, nat.traj_pool, rtol=0.0, atol=2e-2)


# -- player ---------------------------------------------------------------------

def _port_spec(jspec, **kw):
    """The port's spec over the JAX spec's decoder weights and stats."""
    hidden = jspec.params["decoder"]["moe0"]["w"].shape[-1]
    experts = jspec.params["decoder"]["moe0"]["w"].shape[0]
    vae = PoseMixtureVAE(P.FRAME_SIZE, P.FRAME_SIZE, P.FRAME_SIZE + 2, latent_size=32,
                         hidden_size=hidden, num_experts=experts)
    vae.load_state_dict(CK.mvae_params_from_jax(_flatten(jspec.params)))
    vae.requires_grad_(False)
    return P.MVAEPlayerSpec(decoder=vae, avg=_t(jspec.avg), std=_t(jspec.std),
                            player=jspec.player, righthand=jspec.righthand,
                            is_train=jspec.is_train, **kw)


def _state_arrays(st, prefix=""):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_state_arrays(v, prefix + f.name + "/"))
        elif f.name != "key":
            out[prefix + f.name] = np.asarray(v)
    return out


@pytest.mark.parametrize("player,righthand,is_train", [("federer", True, True),
                                                       ("djokovic", True, False),
                                                       ("nadal", False, True)])
def test_player_reset_and_step_match(player, righthand, is_train):
    """`reset` then three `step`s with residuals for 64 envs whose swing
    types start spread over {-1, 0, 1, 2, 3} and whose decoded phases spread
    over [0, 2pi) (latents x2), so every residual-table row and the
    classification run; non-trivial feature stats. Swing types exact;
    features, rotations and phase to 1e-4."""
    rng = np.random.default_rng(7)
    jspec = JP.make_random_spec(jax.random.PRNGKey(1), player=player, hidden=32, experts=2)
    avg = (rng.standard_normal(P.FRAME_SIZE) * 0.1).astype(np.float32)
    std = rng.uniform(0.5, 1.5, P.FRAME_SIZE).astype(np.float32)
    jspec = dataclasses.replace(jspec, avg=jnp.asarray(avg), std=jnp.asarray(std),
                                righthand=righthand, is_train=is_train)
    tspec = _port_spec(jspec)
    feats = (rng.standard_normal((64, P.FRAME_SIZE)) * 0.3).astype(np.float32)
    root_xy = rng.uniform(-2.0, 2.0, (64, 2)).astype(np.float32)
    js = JP.reset(jspec, jnp.asarray(feats), root_xy=jnp.asarray(root_xy))
    swing = rng.integers(-1, 4, 64).astype(np.int32)
    js = dataclasses.replace(js, swing_type=jnp.asarray(swing),
                             swing_type_cycle=jnp.asarray(np.roll(swing, 1)))
    t_state = P.reset(tspec, _t(feats), root_xy=_t(root_xy))
    t_state = dataclasses.replace(t_state, swing_type=_t(swing, torch.int32),
                                  swing_type_cycle=_t(np.roll(swing, 1), torch.int32))
    phases = []
    for k in range(3):
        z = (rng.standard_normal((64, 32)) * 2.0).astype(np.float32)
        res = (rng.standard_normal((64, 3)) * 2.0).astype(np.float32)
        js = JP.step(jspec, js, jnp.asarray(z), jnp.asarray(res))
        t_state = P.step(tspec, t_state, _t(z), _t(res))
        want, got = _state_arrays(js), _state_arrays(t_state)
        for f in ("swing_type", "swing_type_cycle"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"step {k} {f}")
        for f in ("condition", "root_pos", "root_vel", "joint_rotmat", "joint_pos_kin",
                  "phase_pred"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {k} {f}")
        phases.append(want["phase_pred"])
    phases = np.concatenate(phases)
    assert ((phases > 2.0) & (phases < 3.5)).mean() > 0.1 and (phases > 3.5).any()


# -- racket and frozen π_low ----------------------------------------------------

@pytest.mark.parametrize("grip,righthand", [("eastern", True), ("semi_western", True),
                                            ("lefthand_semi_western", False)])
def test_racket_matches(grip, righthand):
    """`racket_from_wrist` and `racket_with_fk` (the 9-joint pelvis->hand
    chain) on 32 seeded poses: the same f32 products, 1e-5."""
    from vid2player3d_tpu.core import rot as JR
    from vid2player3d_tpu.tennis import racket as JRK
    from vid2player3d_torch.tennis import racket as RK

    rng = np.random.default_rng(8)
    aa = (rng.standard_normal((32, 24, 3)) * 0.5).astype(np.float32)
    rotmat = np.asarray(JR.angle_axis_to_rotmat(jnp.asarray(aa)))
    bind = (rng.standard_normal((32, 24, 3)) * 0.2).astype(np.float32)
    root = rng.standard_normal((32, 3)).astype(np.float32)
    got = RK.racket_from_wrist(_t(root), _t(rotmat[:, 0]), grip)
    want = JRK.racket_from_wrist(jnp.asarray(root), jnp.asarray(rotmat[:, 0]), grip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    got = RK.racket_with_fk(_t(rotmat), _t(bind), _t(root), grip, righthand)
    want = JRK.racket_with_fk(jnp.asarray(rotmat), jnp.asarray(bind), jnp.asarray(root), grip,
                              righthand)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        np.testing.assert_allclose(g if np.isscalar(g) else g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("nested", [False, True], ids=["imitation", "context_ik"])
def test_frozen_imitator_from_jax_checkpoint(tmp_path, nested):
    """`FrozenImitator.from_checkpoint` reads a JAX-format `.npz` (params +
    obs normalizer; context-IK checkpoints nest the actor-critic under
    `params/ac`) and its deterministic action on 16 seeded full-width obs
    matches the JAX `as_pi_low`, to 1e-5."""
    from vid2player3d_tpu.learn import FrozenImitator as JFrozen
    from vid2player3d_tpu.learn import running_norm as JRN
    from vid2player3d_tpu.learn.networks import ImitatorNet as JImitatorNet
    from vid2player3d_tpu.utils.checkpoint import save_pytree
    from vid2player3d_torch.learn import FrozenImitator

    rng = np.random.default_rng(9)
    jnet = JImitatorNet(num_actions=75)
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 734)))
    norm = JRN.RunningNormState(n=jnp.asarray(7.0),
                                mean=jnp.asarray(rng.standard_normal(734).astype(np.float32)),
                                var=jnp.asarray(rng.uniform(0.5, 2, 734).astype(np.float32)))
    path = str(tmp_path / "pi_low.npz")
    save_pytree(path, {"params": {"ac": params} if nested else params, "obs_norm": norm})
    obs = (rng.standard_normal((16, 734)) * 2.0).astype(np.float32)
    jfn, jp = JFrozen(net=jnet, params=params, obs_norm=norm).as_pi_low()
    want = np.asarray(jfn(jp, jnp.asarray(obs)))
    with torch.no_grad():
        got = FrozenImitator.from_checkpoint(path, device="cpu").as_pi_low()(_t(obs)).numpy()
    assert got.shape == (16, 75)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
