"""The port's domain randomization (``envs/domain_rand.py``) against the JAX
package's, fed the JAX draws.

Each JAX method draws from `fold_in(key, i)` (model spec i), `fold_in(key,
3000 + i)` (ball), `1000 + i` (obs) and `2000 + i` (actions); the test draws
the same standard uniforms or normals from those keys and hands them to the
port. The model is the JAX asset model's arrays in the port's container, so
only the randomization is compared. Both compute in float32: the values
agree to a float32 rounding (held: rtol 1e-6, atol 1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.core.smpl import make_synthetic_smpl as j_make_smpl
from vid2player3d_tpu.envs import domain_rand as JDR
from vid2player3d_tpu.physics import asset as JA
from vid2player3d_tpu.tennis import ball as JB
from vid2player3d_torch.envs import domain_rand as DR
from vid2player3d_torch.physics.model import ArticulationModel
from vid2player3d_torch.tennis import ball as B

torch.set_num_threads(1)

N = 8
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def models():
    jm = JA.build_humanoid_model(j_make_smpl(), np.zeros((N, 10), np.float32))
    tm = ArticulationModel(**{
        f.name: (torch.tensor(np.asarray(getattr(jm, f.name))) if f.name not in (
            "parents", "names", "contact_body", "collision_pairs") else getattr(jm, f.name))
        for f in dataclasses.fields(ArticulationModel) if f.init})
    return jm, tm


def _standard(key, spec, shape):
    if spec.distribution == "gaussian":
        return np.asarray(jax.random.normal(key, shape))
    return np.asarray(jax.random.uniform(key, shape))


def _specs(cls, rows):
    return [cls(*r) for r in rows]


MODEL_CASES = {
    "mass_uniform_scaling": [("body_mass", "uniform", (0.8, 1.2), "scaling")],
    "kp_gaussian_additive": [("kp", "gaussian", (0.0, 0.5), "additive")],
    "radius_loguniform_scaling": [("contact_radius", "loguniform", (0.9, 1.1), "scaling")],
    "joint_pos_uniform_additive": [("joint_pos", "uniform", (-0.01, 0.02), "additive")],
    "inertia_loguniform_additive_linear": [
        ("body_inertia", "loguniform", (1e-4, 1e-3), "additive", "linear", 100)],
    "amass_im_dr_model": [("body_mass", "uniform", (0.9, 1.1), "scaling"),
                          ("kp", "uniform", (0.85, 1.15), "scaling")],
}


@pytest.mark.parametrize("step", [0, 50, 200], ids=["step0", "mid", "past"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_randomize_model_matches(models, case, step):
    """One factor per env per field, broadcast over the field's trailing
    dims, with the linear schedule at step 0 (the identity), half way and
    past its end; untouched fields stay as they were."""
    jm, tm = models
    rows = MODEL_CASES[case]
    jdr = JDR.DomainRandomizer(_specs(JDR.RandSpec, rows))
    tdr = DR.DomainRandomizer(_specs(DR.RandSpec, rows))
    key = jax.random.PRNGKey(7)
    want = jdr.randomize_model(key, jm, step=step)
    draws = []
    for i, sp in enumerate(jdr.model_specs):
        v = getattr(jm, sp.field)
        draws.append(_standard(jax.random.fold_in(key, i), sp,
                               (v.shape[0],) + (1,) * (v.ndim - 1)))
    got = tdr.randomize_model(tm, step=step, draws=draws)
    for f in ("joint_pos", "body_com", "body_mass", "body_inertia", "kp", "kd", "torque_lim",
              "armature", "contact_offset", "contact_radius"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    linear = rows[0][4:5] == ("linear",)
    field = rows[0][0]
    moved = not np.array_equal(np.asarray(getattr(want, field)), np.asarray(getattr(jm, field)))
    assert moved == (not linear or step > 0)


BALL_ROWS = [("ball_" + f, "uniform", (0.9, 1.1), "scaling") for f in DR._BALL_FIELDS]


@pytest.mark.parametrize("rows", [BALL_ROWS, [("ball_restitution", "gaussian", (0.0, 0.02),
                                                "additive", "linear", 64)]],
                         ids=["every_field_scaling", "gaussian_additive_linear"])
def test_randomize_ball_matches(rows):
    """One shared scalar per ball field; the ball flies the same under the
    perturbed constants (rtol 1e-5 over 30 frames)."""
    jdr = JDR.DomainRandomizer(_specs(JDR.RandSpec, rows))
    tdr = DR.DomainRandomizer(_specs(DR.RandSpec, rows))
    key = jax.random.PRNGKey(3)
    want = jdr.randomize_ball(key, JB.BallParams(), step=32)
    draws = [_standard(jax.random.fold_in(key, 3000 + i), sp, ())
             for i, sp in enumerate(jdr.ball_specs)]
    got = tdr.randomize_ball(B.BallParams(), step=32, draws=draws, device="cpu")
    for name in B.BallParams._fields:
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    pos, vel, spin = np.array([[0.0, 12.0, 1.0]]), np.array([[0.0, -20.0, 2.0]]), np.array([2.0])
    jr = JB.simulate_flight(jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
                            jnp.asarray(spin, jnp.float32), num_frames=30, p=want)
    tr = B.simulate_flight(torch.tensor(pos, dtype=torch.float32),
                           torch.tensor(vel, dtype=torch.float32),
                           torch.tensor(spin, dtype=torch.float32), num_frames=30, p=got)
    np.testing.assert_allclose(tr.traj.numpy(), np.asarray(jr.traj), rtol=1e-5, atol=1e-5)


NOISE_ROWS = [("observations", "gaussian", (0.0, 0.002), "additive", "linear", 3000),
              ("observations", "uniform", (0.98, 1.02), "scaling"),
              ("actions", "gaussian", (0.0, 0.01), "additive", "linear", 3000),
              ("actions", "loguniform", (0.5, 2.0), "scaling", "linear", 10)]


@pytest.mark.parametrize("step", [0, 1500, 9000], ids=["step0", "mid", "past"])
def test_randomize_obs_and_actions_match(step):
    """Per-element noise of every distribution on the obs and the actions
    (two specs each, applied in order), the linear schedules at step 0, half
    way and past their end."""
    jdr = JDR.DomainRandomizer(_specs(JDR.RandSpec, NOISE_ROWS))
    tdr = DR.DomainRandomizer(_specs(DR.RandSpec, NOISE_ROWS))
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((N, 20)).astype(np.float32)
    act = rng.standard_normal((N, 6)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_o = jdr.randomize_obs(key, jnp.asarray(obs), step)
    want_a = jdr.randomize_actions(key, jnp.asarray(act), step)
    d_o = [_standard(jax.random.fold_in(key, 1000 + i), sp, obs.shape)
           for i, sp in enumerate(jdr.obs_specs)]
    d_a = [_standard(jax.random.fold_in(key, 2000 + i), sp, act.shape)
           for i, sp in enumerate(jdr.act_specs)]
    got_o = tdr.randomize_obs(torch.tensor(obs), step, draws=d_o)
    got_a = tdr.randomize_actions(torch.tensor(act), step, draws=d_a)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 5000])
def test_schedule_scale_matches(step):
    """The linear schedule's strength is the float32 value JAX computes."""
    for steps in (1, 3, 100, 3000):
        js = JDR.RandSpec("kp", schedule="linear", schedule_steps=steps)
        ts = DR.RandSpec("kp", schedule="linear", schedule_steps=steps)
        assert DR._sched_scale(ts, step) == float(JDR._sched_scale(js, jnp.int32(step)))
    assert DR._sched_scale(DR.RandSpec("kp"), step) == 1.0


@pytest.mark.parametrize("spec", [DR.RandSpec("not_a_field"),
                                  DR.RandSpec("ball_bogus", "uniform", (0.9, 1.1)),
                                  DR.RandSpec("ball_gravity", "uniform", (0.9, 1.1)),
                                  DR.RandSpec("kp", "triangular", (0.9, 1.1)),
                                  DR.RandSpec("kp", "uniform", (0.9, 1.1), "power")],
                         ids=["field", "ball_field", "ball_gravity", "distribution",
                              "operation"])
def test_unknown_targets_rejected(spec):
    """Unknown targets raise, ball fields included (gravity is no target), as
    do unknown distributions and operations."""
    with pytest.raises(ValueError):
        DR.DomainRandomizer([spec])


def test_generator_draws_stay_in_range(models):
    """From a generator: factors inside the uniform range, one per env
    (constant within it), other fields untouched; the ball's constants are
    0-d tensors inside their range; a linear schedule at step 0 is the
    identity."""
    _, tm = models
    gen = torch.Generator().manual_seed(0)
    dr = DR.DomainRandomizer([DR.RandSpec("body_mass", "uniform", (0.8, 1.2), "scaling"),
                              DR.RandSpec("ball_base_cd", "uniform", (0.9, 1.1), "scaling")])
    m2 = dr.randomize_model(tm, generator=gen)
    ratio = (m2.body_mass / tm.body_mass).numpy()
    assert (ratio >= 0.8 - 1e-6).all() and (ratio <= 1.2 + 1e-6).all() and ratio.std() > 0.0
    np.testing.assert_allclose(ratio, np.broadcast_to(ratio[:, :1], ratio.shape), rtol=1e-6)
    assert torch.equal(m2.kp, tm.kp)
    p = dr.randomize_ball(B.BallParams(), generator=gen, device="cpu")
    assert p.base_cd.dim() == 0 and 0.9 * 0.55 - 1e-6 <= float(p.base_cd) <= 1.1 * 0.55 + 1e-6
    assert p.mass == B.BallParams().mass
    ramp = DR.DomainRandomizer([DR.RandSpec("body_mass", "uniform", (0.5, 1.5), "scaling",
                                            "linear", 100)])
    assert torch.equal(ramp.randomize_model(tm, step=0, generator=gen).body_mass, tm.body_mass)
