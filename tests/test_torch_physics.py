"""Parity of the port's SMPL asset compiler and articulation engine with the
JAX package: the same betas give the same model arrays, and from a copied
state and the same PD targets and root wrenches, `control_step` (self-
collision on), `fk_world` and `set_state_from_reference` agree.

Inputs are made from a seed with numpy and handed to both packages. The JAX
side runs on the CPU in f32 with highest-precision matmuls (tests/conftest.py);
the port runs in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.core import quat as JQ
from vid2player3d_tpu.core import smpl as JS
from vid2player3d_tpu.physics import asset as JA
from vid2player3d_tpu.physics import engine as JE
from vid2player3d_tpu.physics.model import ArticulationState as JState
from vid2player3d_torch.core import smpl as TS
from vid2player3d_torch.physics import asset as TA
from vid2player3d_torch.physics import engine as TE
from vid2player3d_torch.physics.model import ArticulationModel, ArticulationState

torch.set_num_threads(1)

N = 6
SUBSTEPS = 2
MODEL_FIELDS = ("joint_pos", "body_com", "body_mass", "body_inertia", "kp", "kd",
                "torque_lim", "armature", "contact_offset", "contact_radius")
STATE_FIELDS = ("root_pos", "root_quat", "root_vel", "joint_quat", "joint_omega")


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    betas = (rng.randn(N, 10) * 0.5).astype(np.float32)
    jm = JA.build_humanoid_model(JS.make_synthetic_smpl(), betas, self_collision=True)
    aa = (rng.randn(N, 23, 3) * 0.3).astype(np.float32)
    root_q = np.tile([0.5, 0.5, 0.5, 0.5], (N, 1)) + rng.randn(N, 4) * 0.05
    state = dict(
        root_pos=(np.array([0.0, 0.0, 0.93]) + rng.randn(N, 3) * 0.02).astype(np.float32),
        root_quat=np.asarray(JQ.quat_normalize(jnp.asarray(root_q, jnp.float32))),
        root_vel=(rng.randn(N, 6) * 0.3).astype(np.float32),
        joint_quat=np.asarray(JQ.exp_map_to_quat(jnp.asarray(aa))),
        joint_omega=(rng.randn(N, 23, 3) * 0.5).astype(np.float32))
    inputs = dict(pd=(aa.reshape(N, -1) + rng.randn(N, 69) * 0.2).astype(np.float32),
                  rf=(rng.randn(N, 3) * 20).astype(np.float32),
                  rt=(rng.randn(N, 3) * 20).astype(np.float32))
    # the port's model carries the JAX model's arrays, so the engine is
    # compared on identical inputs (the asset compiler has its own test)
    tm = ArticulationModel(
        parents=jm.parents, names=jm.names, contact_body=jm.contact_body,
        collision_pairs=jm.collision_pairs,
        **{f: torch.tensor(np.asarray(getattr(jm, f))) for f in MODEL_FIELDS})
    step = jax.jit(lambda m, s, pd, rf, rt: JE.control_step(m, s, pd, rf, rt,
                                                            substeps=SUBSTEPS))
    return betas, jm, tm, state, inputs, step


def _j_state(st):
    return JState(**{k: jnp.asarray(v) for k, v in st.items()})


def _t_state(st):
    return ArticulationState(**{k: torch.tensor(v) for k, v in st.items()})


def test_asset_model_arrays_match(case):
    """Every array of the ArticulationModel for the same betas. Tolerance
    1e-6 (abs and rel): f32 einsum order in the shaped vertices and the
    eigen-decomposition of each body's vertex covariance."""
    betas, jm, _, _, _, _ = case
    tm = TA.build_humanoid_model(TS.make_synthetic_smpl(), betas, self_collision=True,
                                device="cpu")
    assert tm.parents == jm.parents
    assert tm.names == jm.names
    assert tm.contact_body == jm.contact_body
    assert tm.collision_pairs == jm.collision_pairs
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    np.testing.assert_allclose(
        TA.min_verts_height(TS.make_synthetic_smpl(), betas),
        JA.min_verts_height(JS.make_synthetic_smpl(), betas), atol=1e-6)


def test_asset_self_collision_pairs_and_parents():
    names = tuple(JS.MUJOCO_JOINT_NAMES)
    assert TA.default_self_collision_pairs(names) == JA.default_self_collision_pairs(names)
    np.testing.assert_array_equal(TA.mujoco_parents(), JA._mujoco_parents())


@pytest.mark.parametrize("nsteps", [1, 4])
def test_control_step_matches(case, nsteps):
    """`nsteps` control steps of 2 substeps with ground contacts, self-
    collision, PD targets and residual root wrenches. Positions and
    quaternions agree to 5e-6; velocities to 2e-4 (on values of ~5): the
    stiff stable-PD ABA (kp up to ~1.5e3, dt 1/60) amplifies one-ulp
    differences of float re-association in the accelerations."""
    _, jm, tm, st, inp, step = case
    a, b = _j_state(st), _t_state(st)
    for _ in range(nsteps):
        a = step(jm, a, jnp.asarray(inp["pd"]), jnp.asarray(inp["rf"]), jnp.asarray(inp["rt"]))
        b = TE.control_step(tm, b, torch.tensor(inp["pd"]), torch.tensor(inp["rf"]),
                            torch.tensor(inp["rt"]), substeps=SUBSTEPS)
    for f in STATE_FIELDS:
        atol = 2e-4 if f in ("root_vel", "joint_omega") else 5e-6
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                   atol=atol, err_msg=f)


def test_fk_world_matches(case):
    """World body poses and velocities; f32 rounding only (1e-6)."""
    _, jm, tm, st, _, _ = case
    for x, y in zip(JE.fk_world(jm, _j_state(st)), TE.fk_world(tm, _t_state(st))):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6)


def test_set_state_from_reference_matches(case):
    """Reset quantities → generalized state; f32 rounding only (1e-6)."""
    _, jm, tm, st, inp, _ = case
    rng = np.random.RandomState(1)
    vel = (rng.randn(N, 3)).astype(np.float32)
    ang = (rng.randn(N, 3)).astype(np.float32)
    dof_vel = (rng.randn(N, 69)).astype(np.float32)
    a = JE.set_state_from_reference(jm, jnp.asarray(st["root_pos"]), jnp.asarray(st["root_quat"]),
                                    jnp.asarray(vel), jnp.asarray(ang), jnp.asarray(inp["pd"]),
                                    jnp.asarray(dof_vel))
    b = TE.set_state_from_reference(tm, torch.tensor(st["root_pos"]),
                                    torch.tensor(st["root_quat"]), torch.tensor(vel),
                                    torch.tensor(ang), torch.tensor(inp["pd"]),
                                    torch.tensor(dof_vel))
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                   atol=1e-6, err_msg=f)
