"""The port's imitation env against the JAX package and its golden rollout.

The JAX env is built as `tests/test_golden_rollout.py` builds it (4 envs,
substeps 2) and reset eagerly with PRNGKey(42); the six action batches are the
same `jax.random` draws. Only eager JAX calls are made, so this file compiles
no JAX step. The port's env is built from its own motion library with the
JAX env's motion ids, takes the JAX reset state, and its six steps must
reproduce `tests/golden/humanoid_rollout.npz`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.utils.checkpoint import env_state_from_jax

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "humanoid_rollout.npz")


def _jax_state_arrays(state):
    sim = state.sim
    return {k: np.asarray(v) for k, v in dict(
        root_pos=sim.root_pos, root_quat=sim.root_quat, root_vel=sim.root_vel,
        joint_quat=sim.joint_quat, joint_omega=sim.joint_omega,
        progress=state.progress, reset_buf=state.reset_buf,
        terminate_buf=state.terminate_buf, motion_times=state.motion_times).items()}


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(JCfg(num_envs=4, substeps=2), j_make_lib(num_motions=2, T=60, fps=30.0, seed=0),
                rng=0)
    jstate, jobs, jctx = jenv.reset_all(jax.random.PRNGKey(42))
    tenv = HumanoidImEnv(HumanoidImConfig(num_envs=4, substeps=2),
                         t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    return jenv, tenv, _jax_state_arrays(jstate), np.asarray(jobs), \
        {k: np.asarray(v) for k, v in jctx.items()}


def test_reset_and_context_match(envs):
    """`reset_all` fed the JAX reset times: state, raw obs and the motion
    context window. 2e-4 covers the f32 finite-difference velocities of the
    two motion libraries (see test_torch_core); 2e-5 the context positions
    and dofs. The context's rotation block is held to 5e-4: the reference's
    slerp returns the midpoint of two frames less than ~1e-3 rad apart
    whatever the blend, so a one-ulp difference between the two libraries can
    flip that branch, a jump of at most |t−½|·|q1−q0| ≤ 5e-4."""
    _, tenv, jst, jobs, jctx = envs
    state, obs, ctx = tenv.reset_all(motion_times=jst["motion_times"].copy())
    got = {"root_pos": state.sim.root_pos, "root_quat": state.sim.root_quat,
           "root_vel": state.sim.root_vel, "joint_quat": state.sim.joint_quat,
           "joint_omega": state.sim.joint_omega}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), jst[k], atol=2e-4, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), jobs, atol=2e-4)
    feat, jfeat = ctx["feat"].numpy(), jctx["feat"]
    rot = slice(72, 168)
    np.testing.assert_allclose(feat[..., rot], jfeat[..., rot], atol=5e-4)
    feat[..., rot] = jfeat[..., rot]
    np.testing.assert_allclose(feat, jfeat, atol=2e-5)
    np.testing.assert_array_equal(ctx["mask"].numpy(), jctx["mask"])


def test_imitation_obs_matches(envs):
    """The 734-dim network-side observation from the same raw obs and
    context frame; f32 rotation math only (1e-5)."""
    jenv, tenv, _, jobs, jctx = envs
    f = jctx["feat"][:, 8]
    args = (f[:, :72].reshape(4, 24, 3), f[:, 72:168].reshape(4, 24, 4), f[:, 168:237])
    jio = jenv.imitation_obs(jnp.asarray(jobs), *(jnp.asarray(a) for a in args))
    tio = tenv.imitation_obs(torch.tensor(jobs), *(torch.tensor(a) for a in args))
    assert tio.shape == (4, 734)
    np.testing.assert_allclose(tio.numpy(), np.asarray(jio), atol=1e-5)


def test_rollout_matches_golden(envs):
    """Six steps from the copied JAX reset state under the golden action
    batches, against `tests/golden/humanoid_rollout.npz`.

    The JAX package's own golden test holds obs to 1e-5 and root position /
    joint quaternions to 1e-6 on the same toolchain. Across frameworks that
    is out of reach: the stiff stable-PD ABA (kp up to ~1.5e3 against small
    link inertias, dt 1/60) turns a one-ulp difference in an acceleration
    into ~1.5e-5 of velocity per control step, and ground and self contacts
    amplify it from step to step. The JAX package itself, started from its
    golden reset state with a one-ulp perturbation, ends 5.3e-4 away from its
    own golden obs after these six steps. Reached by the port: after one
    step obs 1.5e-5; after six, position/rotation/dof obs 6.9e-5, velocity
    obs 3.8e-3 (on velocities of ~6), root position 4.3e-6, joint
    quaternions 2.0e-5. The tolerances below are those with ~2.5x margin."""
    jenv, tenv, jst, _, _ = envs
    state = env_state_from_jax(jst)
    key = jax.random.PRNGKey(7)
    frames = []
    for _ in range(6):
        key, k = jax.random.split(key)
        act = np.asarray(0.1 * jax.random.normal(k, (4, jenv.num_actions)))
        state, out = tenv.step(state, torch.tensor(act))
        frames.append(out.obs.numpy())
    g = np.load(GOLDEN)
    obs = np.stack(frames)
    np.testing.assert_allclose(obs[0], g["obs"][0], atol=5e-5)
    pose, vel = slice(0, 237), slice(237, 450)
    np.testing.assert_allclose(obs[..., pose], g["obs"][..., pose], atol=2e-4)
    np.testing.assert_allclose(obs[..., vel], g["obs"][..., vel], atol=1e-2)
    np.testing.assert_array_equal(obs[..., 450:], g["obs"][..., 450:])
    np.testing.assert_allclose(state.sim.root_pos.numpy(), g["root"], atol=1e-5)
    np.testing.assert_allclose(state.sim.joint_quat.numpy(), g["jq"], atol=5e-5)


def test_divergence_latch(envs):
    """A diverged env (NaN in its state) is sanitized: obs finite with
    identity body quaternions, reward 0, reset and terminate latched; the
    others step normally."""
    _, tenv, jst, _, _ = envs
    bad = dict(jst)
    bad["joint_omega"] = jst["joint_omega"].copy()
    bad["joint_omega"][1, 3] = np.nan
    state, out = tenv.step(env_state_from_jax(bad), torch.zeros(4, 75))
    assert torch.isfinite(out.obs).all()
    np.testing.assert_array_equal(out.obs[1, 72:168].reshape(24, 4).numpy(),
                                  np.tile([0.0, 0.0, 0.0, 1.0], (24, 1)))
    assert float(out.reward[1]) == 0.0 and float(out.reward[0]) > 0.0
    assert int(out.done[1]) == 1 and int(out.terminate[1]) == 1
    assert int(state.reset_buf[1]) == 1 and int(state.reset_buf[0]) == 0


def test_unported_options_raise():
    """Context corruption and domain randomization are ported (their parity
    is in tests/test_torch_corrupt_ik.py and tests/test_torch_dr_epoch.py):
    an env with them builds; an unknown joint to mask or an unknown
    randomization target raises."""
    from vid2player3d_torch.envs.corrupt import TransformSpecs
    from vid2player3d_torch.envs.domain_rand import RandSpec

    lib = t_make_lib(num_motions=1, T=30, device="cpu")
    env = HumanoidImEnv(HumanoidImConfig(
        num_envs=2, transform_specs=TransformSpecs(mask_joints=("Head",)),
        rand_specs=(RandSpec("kp", "uniform", (0.9, 1.1)),)), lib, device="cpu")
    assert env.randomizer.model_specs and env.rest_joints_smpl.shape == (2, 24, 3)
    for kw in ({"transform_specs": TransformSpecs(mask_joints=("Tail",))},
               {"rand_specs": (RandSpec("not_a_field"),)}):
        with pytest.raises(ValueError):
            HumanoidImEnv(HumanoidImConfig(num_envs=2, **kw), lib, device="cpu")
