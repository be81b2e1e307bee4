"""Parity of the engine's public API with the JAX package: `substep` (a free
base with root wrenches, a fixed base, extra per-body wrenches; 1 and 4
substeps), the fixed-base two-body pendulum, `rigid_body_state`,
`ArticulationState.zeros`, `default_humanoid_state` and `native_available`.

The humanoid case is tests/test_torch_physics.py's (6 envs, self-collision
on, the JAX model's arrays carried into the port's model). Inputs are made
from a seed with numpy. JAX runs on the CPU in f32 with highest-precision
matmuls (tests/conftest.py); the port in f32 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_physics import two_body_model as j_two_body_model
from test_torch_physics import N, STATE_FIELDS, _j_state, _t_state, case  # noqa: F401
from vid2player3d_tpu.native import native_available as j_native_available
from vid2player3d_tpu.physics import asset as JA
from vid2player3d_tpu.physics import engine as JE
from vid2player3d_tpu.physics.model import ArticulationState as JState
from vid2player3d_torch.native import native_available
from vid2player3d_torch.physics import asset as TA
from vid2player3d_torch.physics import engine as TE
from vid2player3d_torch.physics import probes
from vid2player3d_torch.physics.model import ArticulationState

torch.set_num_threads(1)

J = 24
MODES = ("free_root_wrench", "fixed_base", "extra_wrench")


def _close(a, b):
    """Positions and quaternions to 5e-6, velocities to 2e-4 (on values of
    ~5), as `test_control_step_matches`: the stiff stable-PD ABA amplifies
    one-ulp differences of float re-association in the accelerations."""
    for f in STATE_FIELDS:
        atol = 2e-4 if f in ("root_vel", "joint_omega") else 5e-6
        np.testing.assert_allclose(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                   atol=atol, err_msg=f)


@functools.lru_cache(maxsize=None)
def _j_substep(fixed_base):
    return jax.jit(lambda m, s, pd, rf, rt, ef, et: JE.substep(
        m, s, pd, rf, rt, extra_force_w=ef, extra_torque_w=et, fixed_base=fixed_base))


@pytest.fixture(scope="module")
def wrenches():
    rng = np.random.RandomState(2)
    return dict(ef=(rng.randn(N, J, 3) * 10).astype(np.float32),
                et=(rng.randn(N, J, 3) * 2).astype(np.float32))


@pytest.mark.parametrize("nsteps", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_substep_matches(case, wrenches, mode, nsteps):
    """`nsteps` substeps at JAX's default dt (1/240) with ground contacts,
    self-collision and PD targets; a free base under the residual root
    wrenches, a fixed base (the root's acceleration pinned to 0), or a
    free base under extra world wrenches on every body."""
    _, jm, tm, st, inp, _ = case
    fixed = mode == "fixed_base"
    root = mode != "extra_wrench"
    extra = mode == "extra_wrench"
    step = _j_substep(fixed)
    j_in = [jnp.asarray(inp["rf"]) if root else None, jnp.asarray(inp["rt"]) if root else None,
            jnp.asarray(wrenches["ef"]) if extra else None,
            jnp.asarray(wrenches["et"]) if extra else None]
    t_in = [torch.tensor(np.asarray(x)) if x is not None else None for x in j_in]
    a, b = _j_state(st), _t_state(st)
    for _ in range(nsteps):
        a = step(jm, a, jnp.asarray(inp["pd"]), *j_in)
        b = TE.substep(tm, b, torch.tensor(inp["pd"]), t_in[0], t_in[1],
                       extra_force_w=t_in[2], extra_torque_w=t_in[3], fixed_base=fixed)
    _close(a, b)
    if fixed:
        # a pinned base keeps its velocity
        np.testing.assert_array_equal(b.root_vel.numpy(), st["root_vel"])


def test_fixed_base_pendulum_matches():
    """The two-body pendulum of tests/test_physics.py (root mass 1e6, arm
    0.5 m, released from 0.1 rad) under a fixed base for 200 substeps of
    1/960 s: the same model arrays, and states within the tolerances
    above."""
    jm = j_two_body_model(root_mass=1e6, child_mass=1.0, arm=0.5)
    tm = probes.two_body_model(1, root_mass=1e6, child_mass=1.0, arm=0.5, device="cpu")
    for f in ("joint_pos", "body_com", "body_mass", "body_inertia", "kp", "kd", "torque_lim",
              "armature", "contact_offset", "contact_radius"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), f)
    h = 0.05
    st = dict(root_pos=np.array([[0.0, 0.0, 5.0]], np.float32),
              root_quat=np.array([[0.0, 0.0, 0.0, 1.0]], np.float32),
              root_vel=np.zeros((1, 6), np.float32),
              joint_quat=np.array([[[np.sin(h), 0.0, 0.0, np.cos(h)]]], np.float32),
              joint_omega=np.zeros((1, 1, 3), np.float32))
    step = jax.jit(lambda s: JE.substep(jm, s, jnp.zeros((1, 3)), dt=1.0 / 960.0,
                                        fixed_base=True))
    a, b = _j_state(st), _t_state(st)
    for _ in range(200):
        a = step(a)
        b = TE.substep(tm, b, torch.zeros(1, 3), dt=1.0 / 960.0, fixed_base=True)
    _close(a, b)
    assert abs(float(b.joint_quat[0, 0, 0])) > 1e-3      # it swings


def test_rigid_body_state_matches(case):
    """World body poses and velocities; f32 rounding only (1e-6)."""
    _, jm, tm, st, _, _ = case
    got = TE.rigid_body_state(tm, _t_state(st))
    want = JE.rigid_body_state(jm, _j_state(st))
    assert len(got) == len(want) == 4
    for x, y in zip(want, got):
        assert y.shape == x.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6)


@pytest.mark.parametrize("root_h", [1.0, 0.37])
def test_zero_and_default_states_match(case, root_h):
    """`ArticulationState.zeros` and `default_humanoid_state`: every field
    exactly JAX's, in f32."""
    _, jm, tm, _, _, _ = case
    pairs = [(JState.zeros(3, J, root_h=root_h),
              ArticulationState.zeros(3, J, root_h=root_h, device="cpu")),
             (JA.default_humanoid_state(jm, N, root_h=root_h),
              TA.default_humanoid_state(tm, N, root_h=root_h))]
    for a, b in pairs:
        for f in STATE_FIELDS:
            assert getattr(b, f).dtype == torch.float32, f
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), f)
    assert TA.default_humanoid_state(tm, N).root_pos[0, 2] == np.float32(0.89)


def test_native_available_matches():
    """Both bindings build the same C++ source with g++: on one machine they
    agree on whether the library builds and loads."""
    assert native_available() == j_native_available()
