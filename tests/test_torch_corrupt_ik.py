"""The port's context corruption (``envs/corrupt.py``), twist-swing IK
(``core/ik.py``) and `ContextHeads` against the JAX package's.

Corruption: the cases of tests/test_corrupt.py on the port, and every
corruption at once fed the JAX draws (`split(key)` gives the noisy-joint
selection and noise keys, `fold_in(key, 7)` the dropout's); positions and
confidences agree to 1e-6 and every mask exactly. IK: the cases of
tests/test_ik.py against the JAX IK on well-conditioned random poses (the
SVD's signs may differ between LAPACK and XLA, R = V·D·Uᵀ does not when the
singular values are distinct): rotations and joints agree to 1e-5; the
gradient into the twist and leaf residuals to 1e-4 of its scale, zeroed
context joints included. The all-zero system gives the identity in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.core import ik as JIK
from vid2player3d_tpu.core import rot as JR
from vid2player3d_tpu.core.smpl import batch_rigid_transform, make_synthetic_smpl, rest_joints
from vid2player3d_tpu.envs import corrupt as JC
from vid2player3d_tpu.learn.networks import ContextHeads as JHeads
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.core import ik as IK
from vid2player3d_torch.core import smpl as S
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.envs import corrupt as C
from vid2player3d_torch.learn.networks import ContextHeads
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

NAMES = S.SMPL_BONE_ORDER_NAMES


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _pos(B=3, L=5):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, L, 24, 3)))


# -- corruption -----------------------------------------------------------------

def test_identity_when_inactive():
    pos = _t(_pos())
    for specs in (None, C.TransformSpecs()):
        out, conf = C.corrupt_body_pos(pos, specs)
        assert torch.equal(out, pos) and float(conf.min()) == 1.0


def test_mask_named_joints():
    pos = _t(_pos())
    specs = C.TransformSpecs(mask_joints=("L_Wrist", "R_Wrist", "Head"))
    out, conf = C.corrupt_body_pos(pos, specs)
    for j in specs.mask_joints:
        i = NAMES.index(j)
        assert float(out[..., i, :].abs().max()) == 0.0 and float(conf[..., i].max()) == 0.0
    i = NAMES.index("Pelvis")
    assert torch.equal(out[..., i, :], pos[..., i, :]) and float(conf[..., i].min()) == 1.0


def test_noisy_joints_confidence():
    pos = _t(_pos())
    specs = C.TransformSpecs(noisy_joints_prob=1.0, noisy_joints_noise_std=0.05,
                             noisy_joints_conf_std=0.02, noisy_joints_min_conf=0.1)
    out, conf = C.corrupt_body_pos(pos, specs, generator=torch.Generator().manual_seed(2))
    assert bool(((conf >= 0.0) & (conf <= 1.0)).all())
    occ = conf == 0.0
    assert bool(occ.any()) and float(out[occ].abs().max()) == 0.0
    err = torch.linalg.norm(out - pos, dim=-1)
    assert float(err[~occ].max()) < 0.5


def test_random_dropout_never_drops_root():
    specs = C.TransformSpecs(mask_random_joints_prob=0.9)
    _, conf = C.corrupt_body_pos(_t(_pos()), specs, generator=torch.Generator().manual_seed(3))
    assert bool((conf[..., 0] == 1.0).all()) and bool((conf == 0.0).any())


@pytest.mark.parametrize("names", ["smpl", "mujoco"])
def test_corruption_matches_jax(names):
    """Every corruption at once (the amass_im_corrupt noise and dropout plus
    two named masks), fed the JAX draws, under both joint orders."""
    body_names = tuple(NAMES if names == "smpl" else S.MUJOCO_JOINT_NAMES)
    kw = dict(mask_joints=("L_Toe", "Head"), noisy_joints_prob=0.5, noisy_joints_noise_std=0.02,
              noisy_joints_conf_std=0.02, noisy_joints_min_conf=0.1, mask_random_joints_prob=0.05)
    pos = _pos(4, 6)
    key = jax.random.PRNGKey(9)
    want_pos, want_conf = JC.corrupt_body_pos(key, jnp.asarray(pos), JC.TransformSpecs(**kw),
                                              body_names=body_names)
    k_sel, k_noise = jax.random.split(key)
    draws = {"sel_u": np.asarray(jax.random.uniform(k_sel, pos.shape[:-1])),
             "noise": np.asarray(jax.random.normal(k_noise, pos.shape)),
             "drop_u": np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), pos.shape[:-1]))}
    got_pos, got_conf = C.corrupt_body_pos(_t(pos), C.TransformSpecs(**kw), body_names=body_names,
                                           draws=draws)
    np.testing.assert_array_equal(got_conf.numpy() == 0.0, np.asarray(want_conf) == 0.0)
    np.testing.assert_allclose(got_conf.numpy(), np.asarray(want_conf), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), rtol=1e-6, atol=1e-6)
    assert 0 < int((got_conf.numpy() == 0.0).sum()) < got_conf.numel()


def test_env_context_corrupts_the_observed_block_only():
    """The env's context: named masks resolve against the MuJoCo order (L_Toe
    is index 4 there, 10 in SMPL order), the confidence is the real one, and
    the ground-truth blocks stay clean."""
    lib = make_synthetic_motion_lib(num_motions=2, T=30, seed=0, device="cpu")
    specs = C.TransformSpecs(mask_joints=("L_Toe", "R_Toe"))
    env = HumanoidImEnv(HumanoidImConfig(num_envs=2, substeps=2, transform_specs=specs), lib,
                        device="cpu")
    _, _, ctx = env.reset_all(generator=torch.Generator().manual_seed(0))
    lt, rt = S.MUJOCO_JOINT_NAMES.index("L_Toe"), S.MUJOCO_JOINT_NAMES.index("R_Toe")
    conf, feat = ctx["conf"], ctx["feat"]
    assert conf.shape == feat.shape[:2] + (24,)
    assert float(conf[..., [lt, rt]].max()) == 0.0 and float(conf[..., 0].min()) == 1.0
    obs = feat[..., :72].reshape(feat.shape[:2] + (24, 3))
    gt = feat[..., 237:309].reshape(feat.shape[:2] + (24, 3))
    assert float(obs[..., lt, :].abs().max()) == 0.0 and float(gt[..., lt, :].abs().max()) > 0.0
    assert torch.equal(obs[..., 0, :], gt[..., 0, :])
    with pytest.raises(ValueError):
        HumanoidImEnv(HumanoidImConfig(num_envs=2, transform_specs=C.TransformSpecs(
            mask_joints=("Tail",))), lib, device="cpu")


# -- the IK ---------------------------------------------------------------------

def _rest(B):
    return np.asarray(rest_joints(make_synthetic_smpl(), jnp.zeros((B, 10)))).astype(np.float32)


def _targets(B, seed, scale=0.4):
    """FK of a random moderate pose; (targets, rest)."""
    rest = _rest(B)
    aa = np.random.RandomState(seed).uniform(-scale, scale, (B, 24, 3)).astype(np.float32)
    posed, _ = batch_rigid_transform(JR.angle_axis_to_rotmat(jnp.asarray(aa)), jnp.asarray(rest))
    return np.array(posed), rest


def _phis(B, seed):
    return (0.1 * np.random.RandomState(seed).standard_normal((B, 23, 2)) + [1.0, 0.0]
            ).astype(np.float32)


@pytest.mark.parametrize("outlier", [False, True], ids=["plain", "ignore_outlier"])
def test_ik_matches_jax(outlier):
    """Random poses and twists, leaf rotations given: local and global
    rotations and the FK joints; and the FK reproduces the targets (the
    spine's children by a least-squares fit, the others exactly)."""
    B = 6
    targets, rest = _targets(B, seed=1)
    phis = _phis(B, 2)
    leaf = np.asarray(JR.rot6d_to_rotmat(jnp.asarray(
        np.random.RandomState(3).standard_normal((B, 5, 6)).astype(np.float32))))
    want = JIK.batch_inverse_kinematics(jnp.asarray(targets), jnp.asarray(phis),
                                        jnp.asarray(rest), jnp.asarray(leaf),
                                        ignore_outlier=outlier)
    got = IK.batch_inverse_kinematics(_t(targets), _t(phis), _t(rest), _t(leaf),
                                      ignore_outlier=outlier)
    for g, w, name in zip(got, want, ("local", "chain", "joints")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    if not outlier:
        expect = targets - targets[:, :1] + rest[:, :1]
        err = np.linalg.norm(got[2].numpy() - expect, axis=-1)
        exact = [j for j in range(24) if j not in (12, 13, 14)]
        assert err[:, exact].max() < 2e-3 and err.max() < 5e-2


def test_ik_rotations_valid_and_identity_pose():
    B = 3
    targets, rest = _targets(B, seed=2)
    phis = torch.tensor([1.0, 0.0]).expand(B, 23, 2)
    local, chain, _ = IK.batch_inverse_kinematics(_t(targets), phis, _t(rest))
    for M in (local, chain):
        np.testing.assert_allclose((M @ M.transpose(-1, -2)).numpy(),
                                   np.broadcast_to(np.eye(3), M.shape), atol=1e-4)
        np.testing.assert_allclose(torch.linalg.det(M).numpy(), 1.0, atol=1e-4)
    local, _, joints = IK.batch_inverse_kinematics(_t(rest), phis, _t(rest))
    np.testing.assert_allclose(local.numpy(), np.broadcast_to(np.eye(3), local.shape), atol=1e-4)
    np.testing.assert_allclose(joints.numpy(), rest, atol=1e-5)


def test_naive_variant_matches_jax():
    B = 2
    targets, rest = _targets(B, seed=3)
    phis = _phis(B, 4)
    want = JIK.batch_inverse_kinematics_naive(jnp.asarray(targets), jnp.asarray(phis),
                                              jnp.asarray(rest))
    got = IK.batch_inverse_kinematics_naive(_t(targets), _t(phis), _t(rest))
    for g, w in zip(got, want):
        assert g.shape == (B, 24, 3, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_degenerate_system_gives_identity():
    """An all-zero Procrustes system gives the identity in both packages; so
    does the pelvis fit of all-zero targets, and the whole IK of them stays
    finite and orthonormal (to 1e-3). (The spine fit of those targets is rank
    deficient, its rotation not unique: no parity is asked of it.)"""
    B = 2
    rest = _rest(B)
    zeros = np.zeros((B, 24, 3), np.float32)
    phis = np.broadcast_to(np.array([1.0, 0.0], np.float32), (B, 23, 2))
    got = IK.batch_inverse_kinematics(_t(zeros), _t(phis), _t(rest))
    want = JIK.batch_inverse_kinematics(jnp.asarray(zeros), jnp.asarray(phis), jnp.asarray(rest))
    eye = np.broadcast_to(np.eye(3), (B, 3, 3))
    for M, W in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(M[:, 0].numpy(), eye)
        np.testing.assert_array_equal(np.asarray(W[:, 0]), eye)
        assert bool(torch.isfinite(M).all())
        # swings of near-zero bones: orthonormal to 3e-4 (measured)
        np.testing.assert_allclose((M @ M.transpose(-1, -2)).numpy(),
                                   np.broadcast_to(np.eye(3), M.shape), atol=1e-3)
    assert bool(torch.isfinite(got[2]).all())
    zero = np.zeros((B, 3, 3), np.float32)
    np.testing.assert_array_equal(IK._kabsch(_t(zero), _t(zero)).numpy(), eye)
    np.testing.assert_array_equal(np.asarray(JIK._kabsch(jnp.asarray(zero), jnp.asarray(zero))),
                                  eye)


def _ctx_inputs(B, seed, zero_joints=()):
    targets, rest = _targets(B, seed)
    targets[:, list(zero_joints)] = 0.0
    rng = np.random.RandomState(seed + 10)
    phis = (0.1 * rng.standard_normal((B, 46))).astype(np.float32)
    leaf = (0.1 * rng.standard_normal((B, 30))).astype(np.float32)
    return targets, rest, phis, leaf


@jax.jit
def _jax_context_ik_and_grad(targets, rest, phis, leaf, w):
    def loss(p, lf):
        loc, ch, jo = JIK.perform_context_ik(targets, rest, p, lf)
        return (loc ** 2).sum() * 0.1 + (ch[..., 0] ** 3).sum() + (jo * w).sum()

    return JIK.perform_context_ik(targets, rest, phis, leaf), \
        jax.grad(loss, argnums=(0, 1))(phis, leaf)


@pytest.mark.parametrize("zero_joints", [(), (4, 18, 21)], ids=["clean", "zeroed_joints"])
def test_perform_context_ik_and_gradient_match(zero_joints):
    """The context pipeline's IK with residual twists and leaf rot6d: the
    outputs (the joints re-rooted at the targets' root) and the gradient of
    a loss on all three outputs into both residuals, with context joints
    zeroed as occlusion does."""
    B = 3
    targets, rest, phis, leaf = _ctx_inputs(B, 4, zero_joints)
    w = np.random.RandomState(5).standard_normal((24, 3)).astype(np.float32)
    want, jg = _jax_context_ik_and_grad(*(jnp.asarray(x) for x in (targets, rest, phis, leaf,
                                                                   w)))

    tp, tl = _t(phis).requires_grad_(True), _t(leaf).requires_grad_(True)
    got = IK.perform_context_ik(_t(targets), _t(rest), tp, tl)
    loss = (got[0] ** 2).sum() * 0.1 + (got[1][..., 0] ** 3).sum() + (got[2] * _t(w)).sum()
    tg = torch.autograd.grad(loss, (tp, tl))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), atol=1e-5)
    np.testing.assert_allclose(got[2][:, 0].detach().numpy(), targets[:, 0], atol=1e-5)
    for g, wv in zip(tg, jg):
        assert bool(torch.isfinite(g).all())
        scale = float(np.abs(np.asarray(wv)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-4 * scale)


def test_context_heads_forward_on_carried_weights():
    """`ContextHeads` on the JAX module's weights (its zero heads replaced by
    random ones so the output is not trivially 0), carried through the
    checkpoint mapping: phis and leaf6d agree to 1e-5; a fresh port module
    starts with zero heads."""
    x = np.random.RandomState(0).standard_normal((5, 96)).astype(np.float32)
    jparams = JHeads().init(jax.random.PRNGKey(1), jnp.zeros((1, 96)))
    rng = np.random.RandomState(2)
    p = jax.tree_util.tree_map(np.asarray, jparams)
    for head, n in (("phis", 46), ("leaf6d", 30)):
        p["params"][head]["kernel"] = (0.05 * rng.standard_normal((128, n))).astype(np.float32)
        p["params"][head]["bias"] = (0.05 * rng.standard_normal(n)).astype(np.float32)
    want = JHeads().apply(p, jnp.asarray(x))
    state = CK.params_from_jax({"params/ctx/" + k: v for k, v in _flatten(p).items()})
    assert sorted(state) == sorted("ctx." + k for k in ContextHeads().state_dict())
    net = ContextHeads()
    net.load_state_dict({k[4:]: v for k, v in state.items()})
    got = net(_t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    fresh = ContextHeads(generator=torch.Generator().manual_seed(0))
    assert all(float(t.detach().abs().max()) == 0.0 for t in fresh(_t(x)))
