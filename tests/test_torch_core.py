"""Parity of the port's rotation math, SMPL body, skeleton and motion library
with the JAX package.

Seeded numpy batches (with identity, near-identity, negative-w and zero
exp-map edge cases mixed in) go through each JAX function and its port
counterpart. Both run f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.core import quat as JQ
from vid2player3d_tpu.core import rot as JR
from vid2player3d_tpu.core import skeleton as JSK
from vid2player3d_tpu.core import smpl as JS
from vid2player3d_tpu.data import amass as JAM
from vid2player3d_tpu.data import motion_lib as JML
from vid2player3d_tpu.data import synthetic as JSY
from vid2player3d_torch.core import quat as TQ
from vid2player3d_torch.core import rot as TR
from vid2player3d_torch.core import skeleton as TSK
from vid2player3d_torch.core import smpl as TS
from vid2player3d_torch.data import amass as TAM
from vid2player3d_torch.data import motion_lib as TML
from vid2player3d_torch.data import synthetic as TSY

torch.set_num_threads(1)

# Rotation math tolerance: the two frameworks' sin/cos/atan2/arccos differ by
# an ulp or so, and the near-identity branches divide by |xyz| ~ 1e-3.
ROT_ATOL = 1e-5


def _inputs(seed=0, n=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [0, 0, 0, 1]
    q[1] = [0, 0, 0, -1]
    q[2] = [1e-4, -2e-4, 5e-5, 1.0]
    q[2] /= np.linalg.norm(q[2])
    q[3] = [0.5, 0.5, 0.5, 0.5]
    e = (rng.randn(n, 3) * 1.5).astype(np.float32)
    e[0] = 0.0
    e[1] = [1e-7, 0, 0]
    v = rng.randn(n, 3).astype(np.float32)
    v2 = rng.randn(n, 3).astype(np.float32)
    v2[0] = v[0] * 2.0      # same direction
    v2[1] = -v[1]           # opposite
    v2[2] = [-3.0, 0, 0]
    v[2] = [1.0, 0, 0]      # opposite along x: the y-axis fallback
    ang = (rng.rand(n).astype(np.float32) - 0.5) * 8.0
    t = rng.rand(n, 1).astype(np.float32)
    q2 = rng.randn(n, 4).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    q2[0] = q[0]
    q2[1] = -q[1] * (1 - 1e-7)
    r6 = rng.randn(n, 6).astype(np.float32)
    r6[0] = 0.0
    eul = (rng.rand(n, 3).astype(np.float32) - 0.5) * 6.0
    return dict(q=q, q2=q2, e=e, v=v, v2=v2, ang=ang, t=t, r6=r6, eul=eul,
                m=np.asarray(JQ.quat_to_rotmat(jnp.asarray(q))))


# (name, module pair, argument names)
CASES = [
    ("normalize_angle", "Q", ("ang",)), ("quat_from_angle_axis", "Q", ("ang", "v")),
    ("quat_pos", "Q", ("q",)), ("quat_abs", "Q", ("q",)), ("quat_unit", "Q", ("q",)),
    ("quat_normalize", "Q", ("q",)), ("quat_mul", "Q", ("q", "q2")),
    ("quat_mul_norm", "Q", ("q", "q2")), ("quat_conjugate", "Q", ("q",)),
    ("quat_rotate", "Q", ("q", "v")), ("quat_rotate_inverse", "Q", ("q", "v")),
    ("quat_to_angle_axis", "Q", ("q",)), ("quat_to_exp_map", "Q", ("q",)),
    ("exp_map_to_angle_axis", "Q", ("e",)), ("exp_map_to_quat", "Q", ("e",)),
    ("quat_to_tan_norm", "Q", ("q",)), ("quat_to_rotmat", "Q", ("q",)),
    ("rotmat_to_quat", "Q", ("m",)), ("slerp", "Q", ("q", "q2", "t")),
    ("calc_heading", "Q", ("q",)), ("calc_heading_quat", "Q", ("q",)),
    ("calc_heading_quat_inv", "Q", ("q",)),
    ("calc_heading_quat_inv_with_heading", "Q", ("q",)),
    ("remove_base_rot", "Q", ("q",)), ("quat_angle", "Q", ("q",)),
    ("quat_angle_diff", "Q", ("q", "q2")), ("quat_between_two_vec", "Q", ("v", "v2")),
    ("heading_to_vec", "Q", ("ang",)), ("vec_to_heading", "Q", ("v",)),
    ("quat_from_euler_xyz", "Q", ("ang", "ang", "ang")),
    ("angle_axis_to_rotmat", "R", ("e",)), ("rotmat_to_angle_axis", "R", ("m",)),
    ("angle_axis_to_quat", "R", ("e",)), ("quat_to_angle_axis_vec", "R", ("q",)),
    ("rotmat_to_rot6d", "R", ("m",)), ("rot6d_to_rotmat", "R", ("r6",)),
    ("angle_axis_to_rot6d", "R", ("e",)), ("rot6d_to_angle_axis", "R", ("r6",)),
    ("quat_to_rot6d", "R", ("q",)), ("rot6d_to_quat", "R", ("r6",)),
    ("ypr_euler_from_quat", "R", ("q",)), ("quat_from_ypr_euler", "R", ("eul",)),
    ("get_heading_q", "R", ("q",)), ("deheading_quat", "R", ("q",)),
    ("safe_atan2", "R", ("ang", "ang")),
]


@pytest.mark.parametrize("name,mod,args", CASES, ids=[c[0] for c in CASES])
def test_rotation_math_matches(name, mod, args):
    inp = _inputs()
    jf = getattr(JQ if mod == "Q" else JR, name)
    tf = getattr(TQ if mod == "Q" else TR, name)
    if name == "vec_to_heading":
        ja = (jnp.asarray(inp["v"][:, :2]),)
        ta = (torch.tensor(inp["v"][:, :2]),)
    else:
        ja = tuple(jnp.asarray(inp[a]) for a in args)
        ta = tuple(torch.tensor(inp[a]) for a in args)
    jout, tout = jf(*ja), tf(*ta)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for x, y in zip(jout, tout):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=ROT_ATOL, err_msg=name)


def test_smpl_tables_and_synthetic_body_equal():
    """Joint tables are re-declared in the port; the synthetic body is
    seeded by numpy, so both must be identical."""
    np.testing.assert_array_equal(TS.SMPL_PARENTS, JS.SMPL_PARENTS)
    np.testing.assert_array_equal(TS.SMPL_2_MUJOCO, JS.SMPL_2_MUJOCO)
    np.testing.assert_array_equal(TS.MUJOCO_2_SMPL, JS.MUJOCO_2_SMPL)
    assert TS.SMPL_BONE_ORDER_NAMES == JS.SMPL_BONE_ORDER_NAMES
    assert TS.MUJOCO_JOINT_NAMES == JS.MUJOCO_JOINT_NAMES
    jb, tb = JS.make_synthetic_smpl(), TS.make_synthetic_smpl()
    for f in ("v_template", "shapedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    assert tb.posedirs is None and jb.posedirs is None


def test_smpl_lbs_matches():
    """Shaped vertices, rest joints and posed LBS for seeded betas/poses;
    2e-5 covers f32 einsum order and the 24-deep 4x4 transform chain."""
    rng = np.random.RandomState(2)
    betas = (rng.randn(3, 10) * 0.5).astype(np.float32)
    pose = (rng.randn(3, 72) * 0.4).astype(np.float32)
    trans = rng.randn(3, 3).astype(np.float32)
    jb, tb = JS.make_synthetic_smpl(), TS.make_synthetic_smpl()
    np.testing.assert_allclose(TS.rest_joints(tb, torch.tensor(betas)).numpy(),
                               np.asarray(JS.rest_joints(jb, jnp.asarray(betas))), atol=2e-6)
    jv, jj = JS.lbs(jb, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(trans))
    tv, tj = TS.lbs(tb, torch.tensor(betas), torch.tensor(pose), torch.tensor(trans))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=2e-5)


def test_skeleton_tree_and_fk_match():
    rng = np.random.RandomState(3)
    betas = (rng.randn(10) * 0.5).astype(np.float32)
    jt = JAM.humanoid_skeleton_tree(JS.make_synthetic_smpl(), betas)
    tt = TAM.humanoid_skeleton_tree(TS.make_synthetic_smpl(), betas)
    assert tt.node_names == jt.node_names
    np.testing.assert_array_equal(tt.parent_indices, jt.parent_indices)
    np.testing.assert_allclose(tt.local_translation.numpy(),
                               np.asarray(jt.local_translation), atol=1e-6)
    lr = np.asarray(JQ.exp_map_to_quat(jnp.asarray(
        (rng.randn(5, 24, 3) * 0.5).astype(np.float32))))
    root = rng.randn(5, 3).astype(np.float32)
    jr, jp = JSK.fk_local_to_global(jt, jnp.asarray(lr), jnp.asarray(root))
    tr, tp = TSK.fk_local_to_global(tt, torch.tensor(lr), torch.tensor(root))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)


@pytest.fixture(scope="module")
def libs():
    jl = JSY.make_synthetic_motion_lib(num_motions=3, T=45, fps=30.0, seed=1)
    tl = TSY.make_synthetic_motion_lib(num_motions=3, T=45, fps=30.0, seed=1, device="cpu")
    return jl, tl


# Frame arrays come from the same numpy draws through f32 rotation math;
# velocities are finite differences over dt = 1/30 (×30 on one-ulp quaternion
# differences) and the dof velocities also divide by small rotation angles.
LIB_ATOL = {"gts": 2e-6, "grs": 2e-6, "lrs": 2e-6, "grvs": 5e-5, "gravs": 1e-4,
            "dvs": 2e-4}


@pytest.mark.parametrize("field", [
    "gts", "grs", "lrs", "grvs", "gravs", "dvs", "length_starts", "motion_lengths",
    "motion_num_frames", "motion_dt", "motion_weights", "motion_bodies",
    "motion_body_scales", "motion_min_verts_h", "key_body_ids"])
def test_synthetic_motion_lib_matches(libs, field):
    jl, tl = libs
    np.testing.assert_allclose(getattr(tl, field).numpy(), np.asarray(getattr(jl, field)),
                               atol=LIB_ATOL.get(field, 1e-6), err_msg=field)


def test_get_motion_state_and_sample_time_match(libs):
    """State lookup at the same (motion, time) pairs, past-the-end and zero
    times included; `sample_time` fed the JAX uniform draws reproduces the
    JAX times."""
    jl, tl = libs
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 3, size=40)
    times = (rng.rand(40) * 1.6).astype(np.float32)
    times[:3] = [0.0, 1.4666667, 5.0]
    js = JML.get_motion_state(jl, jnp.asarray(ids), jnp.asarray(times), ground_tolerance=0.01)
    ts = TML.get_motion_state(tl, torch.tensor(ids), torch.tensor(times), ground_tolerance=0.01)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=2e-4, err_msg=k)

    key = jax.random.PRNGKey(5)
    phase = np.asarray(jax.random.uniform(key, ids.shape))
    jt = JML.sample_time(jl, key, jnp.asarray(ids), truncate_time=0.5)
    tt = TML.sample_time(tl, torch.tensor(ids), truncate_time=0.5, phase=torch.tensor(phase))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)


def test_sample_motions_draws_by_length(libs):
    """The port draws motion ids from a torch.Generator, weighted by motion
    length as the JAX package does (equal lengths here → uniform)."""
    _, tl = libs
    ids = TML.sample_motions(tl, 3000, torch.Generator().manual_seed(0))
    counts = np.bincount(ids.numpy(), minlength=3) / 3000.0
    np.testing.assert_allclose(counts, [1 / 3] * 3, atol=0.04)
    again = TML.sample_motions(tl, 3000, torch.Generator().manual_seed(0))
    assert torch.equal(ids, again)
