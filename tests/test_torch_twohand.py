"""The port's two-hand-backhand IK (`tennis/twohand.py`) against the JAX
package's: the handle target, the Adam loop for both racket hands with and
without a mask, the gradient at a zero angle and the absolute value's
gradient at 0. All f32 on the CPU, inputs made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.core import rot as JR
from vid2player3d_tpu.core.smpl import batch_rigid_transform as j_brt
from vid2player3d_tpu.tennis import twohand as JT
from vid2player3d_torch.core import rot as R
from vid2player3d_torch.core.smpl import SMPL_BONE_ORDER_NAMES, batch_rigid_transform
from vid2player3d_torch.tennis import twohand as T

torch.set_num_threads(1)

N = 16


def _pose(seed):
    """(rotmat (N, 24, 3, 3), rest (N, 24, 3), mask (N,)): random SMPL
    rotations with the pelvis, torso and spine, one whole row and, on half
    the rows, the free arms' joints at the identity (aa0 = 0, where the
    angle-axis map is at its zero-angle branch); rest joints a random walk
    down the tree."""
    rng = np.random.default_rng(seed)
    aa = (rng.standard_normal((N, 24, 3)) * 0.4).astype(np.float32)
    aa[:, [0, 3, 6]] = 0.0
    aa[3] = 0.0
    aa[::2, list(T._IK_RIGHT + T._IK_LEFT)] = 0.0
    rotmat = np.asarray(JR.angle_axis_to_rotmat(jnp.asarray(aa)))
    rest = np.cumsum(rng.standard_normal((N, 24, 3)) * 0.1, axis=1).astype(np.float32)
    mask = rng.random(N) < 0.5
    mask[:2] = (True, False)
    return rotmat, rest, mask


@pytest.mark.parametrize("righthand", [True, False], ids=["right", "left"])
def test_two_hand_target_matches(righthand):
    """The handle target 2·hand − wrist − pelvis on 16 seeded posed
    skeletons: the same three f32 terms, exact to 1e-6."""
    posed = np.random.default_rng(1).standard_normal((N, 24, 3)).astype(np.float32)
    got = T.two_hand_target(torch.tensor(posed), righthand).numpy()
    want = np.asarray(JT.two_hand_target(jnp.asarray(posed), righthand))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("iters", [1, 8, 50])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("righthand", [True, False], ids=["right", "left"])
def test_optimize_two_hand_backhand_matches(righthand, masked, iters):
    """`optimize_two_hand_backhand` on 16 seeded poses for either racket
    hand, with a mask (rows off the mask pass through bit for bit) and
    without, after 1, 8 and 50 Adam steps. One step moves each delta by ±lr
    by the sign of its gradient, so it checks the gradient's sign everywhere,
    the zero-angle joints and the L1 terms at 0 included. Reached: 5.5e-7
    after 50 steps (rotation entries); held 1e-5. The fix moves the free
    hand toward the handle target."""
    rotmat, rest, mask = _pose(2 + int(righthand))
    m = mask if masked else None
    got = T.optimize_two_hand_backhand(torch.tensor(rotmat), torch.tensor(rest),
                                       righthand=righthand, iters=iters,
                                       mask=None if m is None else torch.tensor(m)).numpy()
    want = np.asarray(JT.optimize_two_hand_backhand(
        jnp.asarray(rotmat), jnp.asarray(rest), righthand=righthand, iters=iters,
        mask=None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want - rotmat).max() > 0.01
    if m is not None:
        np.testing.assert_array_equal(got[~m], rotmat[~m])
    fh = SMPL_BONE_ORDER_NAMES.index("L_Hand" if righthand else "R_Hand")
    posed0, _ = batch_rigid_transform(torch.tensor(rotmat), torch.tensor(rest))
    posed1, _ = batch_rigid_transform(torch.tensor(got), torch.tensor(rest))
    tgt = T.two_hand_target(posed0, righthand)
    rows = torch.tensor(m) if m is not None else slice(None)
    err0 = torch.linalg.norm(posed0[rows, fh] - tgt[rows], dim=-1).mean()
    err1 = torch.linalg.norm(posed1[rows, fh] - tgt[rows], dim=-1).mean()
    assert err1 < err0


def test_ik_posed_joints_match():
    """The port's `batch_rigid_transform` (the IK's forward) on the test
    poses against the JAX package's: 1e-6."""
    rotmat, rest, _ = _pose(4)
    got, _ = batch_rigid_transform(torch.tensor(rotmat), torch.tensor(rest))
    want, _ = j_brt(jnp.asarray(rotmat), jnp.asarray(rest))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_angle_axis_gradient_at_zero_angle():
    """Rest-pose joints have aa0 = 0. The gradient of a weighted sum of
    `angle_axis_to_rotmat(aa)` at aa = 0 is finite in both packages, and the
    same (0: the small-angle branch returns the identity), as is the one at
    a small nonzero angle (1e-6)."""
    w = np.random.default_rng(5).standard_normal((4, 3, 3)).astype(np.float32)
    for aa in (np.zeros((4, 3), np.float32),
               np.array([[0.3, -0.2, 0.1], [1e-3, 0, 0], [0, 0, 2.0], [-0.5, 0.5, 0.5]],
                        np.float32)):
        x = torch.tensor(aa, requires_grad=True)
        (g,) = torch.autograd.grad((R.angle_axis_to_rotmat(x) * torch.tensor(w)).sum(), x)
        want = np.asarray(jax.grad(
            lambda a: (JR.angle_axis_to_rotmat(a) * jnp.asarray(w)).sum())(jnp.asarray(aa)))
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6)


def test_abs_gradient_is_jaxs():
    """`abs_jax`'s gradient is JAX's: +1 at 0.0 and at -0.0, the sign
    elsewhere (±tiny included); torch.abs's is 0 at 0, which would freeze
    every delta on the IK's first Adam step."""
    xs = [0.0, -0.0, 1e-30, -1e-30, 1e-8, -1e-8, 2.5, -2.5]
    x = torch.tensor(xs, requires_grad=True)
    (g,) = torch.autograd.grad(T.abs_jax(x).sum(), x)
    want = [float(jax.grad(jnp.abs)(jnp.float32(v))) for v in xs]
    assert g.tolist() == want
    assert want[:2] == [1.0, 1.0]
    torch.testing.assert_close(T.abs_jax(x).detach(), torch.tensor(xs).abs(), rtol=0, atol=0)
    (g0,) = torch.autograd.grad(torch.abs(x).sum(), x)
    assert g0[0] == 0.0
