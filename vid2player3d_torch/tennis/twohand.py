"""Two-hand-backhand IK (PyTorch counterpart of
``vid2player3d_tpu/tennis/twohand.py``).

The free (non-racket) arm's thorax/shoulder/elbow/wrist rotations are
adjusted so the free hand grips the racket handle: the point one hand-length
beyond the racket hand, `target = 2·hand − wrist − pelvis`. A fixed number of
Adam steps on angle-axis deltas of those four joints minimizes an L1 distance
to the target plus an L1 regularizer on the deltas.

Both losses are means over ALL rows, and the mask applies only at the end,
as in the JAX package: the means' denominators scale every row's gradient
against Adam's eps, so gathering the masked rows would change the result.
The gradient comes from autograd on a detached leaf under a local
`torch.enable_grad()`, so the fix also runs inside the rollout's
`torch.no_grad()`; it makes no host copy and no host sync, so a CUDA graph
of the env step holds the fix, its backward included. The absolute value
is `abs_jax`: its gradient at 0 is +1, as `jax.grad(jnp.abs)` gives
(torch.abs gives 0), and the deltas start at exactly 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rot as R
from ..core.smpl import SMPL_BONE_ORDER_NAMES, batch_rigid_transform

_IDX = {n: i for i, n in enumerate(SMPL_BONE_ORDER_NAMES)}

# free-arm IK chains, by the racket hand
_IK_RIGHT = (_IDX["L_Wrist"], _IDX["L_Elbow"], _IDX["L_Shoulder"], _IDX["L_Thorax"])
_IK_LEFT = (_IDX["R_Wrist"], _IDX["R_Elbow"], _IDX["R_Shoulder"], _IDX["R_Thorax"])
# (righthand, device) -> the chain's joints as an index tensor, made once: a
# Python list index is a host copy on every call, which a step replayed from
# a CUDA graph cannot hold
_IK_INDEX: dict = {}


def _ik_index(righthand: bool, device) -> torch.Tensor:
    key = (righthand, torch.device(device))
    if key not in _IK_INDEX:
        _IK_INDEX[key] = torch.tensor(_IK_RIGHT if righthand else _IK_LEFT, dtype=torch.long,
                                      device=device)
    return _IK_INDEX[key]


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 at 0.0 and at -0.0 (JAX's), -1 below 0."""
    return torch.where(x >= 0, x, -x)


def two_hand_target(posed_joints, righthand: bool = True):
    """Handle-grip target of the free hand: 2·hand − wrist − pelvis."""
    h, w = (_IDX["R_Hand"], _IDX["R_Wrist"]) if righthand else (_IDX["L_Hand"], _IDX["L_Wrist"])
    return 2.0 * posed_joints[:, h] - posed_joints[:, w] - posed_joints[:, 0]


def optimize_two_hand_backhand(joint_rotmat, rest_smpl, righthand: bool = True,
                               iters: int = 50, lr: float = 0.05, w_reg: float = 0.1,
                               mask=None, num_rows=None):
    """Adjust the free arm so both hands hold the racket.

    joint_rotmat: (N, 24, 3, 3) SMPL-order local rotations.
    rest_smpl: (N, 24, 3) SMPL-order rest joint positions.
    mask: optional (N,) bool, the rows where the fix applies; the other rows
      pass through unchanged.
    num_rows: the row count the loss's means are over (a data-parallel
      rank's N rows are a block of `num_rows`); default N.

    Returns the adjusted (N, 24, 3, 3) rotations (no autograd history)."""
    ik = _ik_index(righthand, joint_rotmat.device)
    fh = _IDX["L_Hand"] if righthand else _IDX["R_Hand"]
    N = joint_rotmat.shape[0]
    joint_rotmat = joint_rotmat.detach()
    rest_smpl = rest_smpl.detach()

    with torch.no_grad():
        posed0, _ = batch_rigid_transform(joint_rotmat, rest_smpl)
        target = two_hand_target(posed0, righthand)
        aa0 = R.rotmat_to_angle_axis(joint_rotmat.index_select(1, ik).reshape(-1, 3, 3)
                                     ).reshape(N, 4, 3)

    def with_arm(aa):
        return joint_rotmat.index_copy(1, ik, R.angle_axis_to_rotmat(aa.reshape(-1, 3)
                                                                     ).reshape(N, 4, 3, 3))

    def mean(x):
        return x.mean() if num_rows is None else x.sum() / (num_rows * (x.numel() // N))

    def loss_fn(delta):
        posed, _ = batch_rigid_transform(with_arm(aa0 + delta), rest_smpl)
        l_target = mean(abs_jax(posed[:, fh] - target))
        l_reg = mean(abs_jax(delta))
        return l_target + w_reg * l_reg

    # Adam (betas 0.9 / 0.999), bias corrections in float32 as the JAX loop
    # computes them
    delta = torch.zeros_like(aa0)
    m = torch.zeros_like(aa0)
    v = torch.zeros_like(aa0)
    for i in range(iters):
        with torch.enable_grad():
            leaf = delta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
        with torch.no_grad():
            k = np.float32(i + 1.0)
            c1 = float(np.float32(1.0) - np.float32(0.9) ** k)
            c2 = float(np.float32(1.0) - np.float32(0.999) ** k)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            delta = delta - lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8)

    with torch.no_grad():
        new_rm = with_arm(aa0 + delta)
        if mask is not None:
            new_rm = torch.where(mask[:, None, None, None], new_rm, joint_rotmat)
    return new_rm
