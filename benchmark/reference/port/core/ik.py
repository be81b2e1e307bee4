"""Batched analytic twist-and-swing inverse kinematics for the SMPL skeleton
(PyTorch counterpart of ``core/ik.py``).

Given target joint positions (possibly corrupted video estimates), per-bone
twist angles (phis, as cos/sin) and the rest-pose skeleton, recover per-joint
rotation matrices whose FK reproduces the targets. The tree is processed
level by level with static index lists (9 levels); the two orientation fits
(pelvis, spine) are batched 3×3 orthogonal Procrustes fits in Horn's
quaternion form, a fixed number of plain tensor ops with no solver call and
no host sync (so a CUDA graph holds them), degenerate ones masked to the
identity. Everything is differentiable in the twist and leaf inputs; the
fits read only data (the spine fit's target is detached).
"""

from __future__ import annotations

import functools

import torch

from . import rot as R
from .smpl import SMPL_PARENTS, smpl_children_map

_EPS = 1e-8


def _safe_norm(x, dim=-1, keepdim=True):
    """Norm with a finite gradient at 0 (`torch.linalg.norm`'s is NaN there,
    which zeroed context joints reach)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-12)


# Topological levels of the SMPL tree. Level 3 is the 3-child spine joint
# (Chest=9, fit by Procrustes over Neck/L_Thorax/R_Thorax); the last level holds the
# leaves, whose local rotation comes from `leaf_rotmats`.
IK_LEVELS = [
    [0],
    [1, 2, 3],
    [4, 5, 6],
    [9],
    [7, 8, 12, 13, 14],
    [16, 17],
    [18, 19],
    [20, 21],
    [10, 11, 15, 22, 23],
]
SPINE_JOINT = 9
SPINE_CHILDREN = [12, 13, 14]
PELVIS_CHILDREN = [1, 2, 3]
LEAF_JOINTS = IK_LEVELS[-1]

_PARENTS = [int(p) for p in SMPL_PARENTS]
_CHILDREN = [int(c) for c in smpl_children_map()]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The static index lists as tensors on `device`, made once: per level
    after the root its joints, their first children and their phi rows
    (joint - 1); the parents of joints 1..23; the identity twist and 6d."""
    def t(x, dtype=torch.long):
        return torch.tensor(x, dtype=dtype, device=device)

    levels = [(t(lv), t([_CHILDREN[j] for j in lv]), t([j - 1 for j in lv]))
              for lv in IK_LEVELS[1:]]
    return {"levels": levels, "parents": t(_PARENTS[1:]),
            "ident2": t([1.0, 0.0], torch.float32),
            "ident6": t([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], torch.float32)}


# squarings of the shifted Horn matrix: its top eigenvector's share grows as
# the ratio of the two largest eigenvalues to the power 2**k
_HORN_SQUARINGS = 20


def _kabsch(rest_cols, target_cols):
    """Batched orthogonal Procrustes: the proper rotation R minimizing
    |R @ rest - target| for (B, 3, K) matrices of K corresponding vectors.
    All-zero systems give the identity.

    Horn's form: R is the rotation of the unit quaternion that is the top
    eigenvector of the symmetric 4×4 matrix N built from S = rest·targetᵀ.
    N shifted by a bound of its spectral radius is positive semidefinite;
    squared `_HORN_SQUARINGS` times (renormalized by its trace) it tends to
    v·vᵀ, whose column of largest diagonal is ±v. This is the reference's
    V·diag(1, 1, sign det(V·Uᵀ))·Uᵀ of the SVD S = U·Σ·Vᵀ wherever that is
    unique (S of rank 2 or more, apart from a reflection with σ₂ = σ₃); the
    reference's `det == 0` guard never decides there, as det(V·Uᵀ) of
    orthogonal factors is ±1. Of rank 1 every rotation taking S's left to
    its right singular vector is optimal: this picks one, the reference's
    SVD another (there its pick follows the rounding of S)."""
    S = rest_cols @ target_cols.transpose(-1, -2)                # (B, 3, 3)
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    degenerate = torch.abs(S).sum(dim=(-1, -2), keepdim=True) < _EPS
    S = torch.where(degenerate, eye, S)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = (r.unbind(-1) for r in S.unbind(-2))
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1)], -2)
    # |eigenvalues of N| <= σ₁ + σ₂ + σ₃ <= √3·|S|_F
    shift = 1.7320508 * torch.sqrt((S * S).sum((-1, -2)))
    M = N + shift[..., None, None] * torch.eye(4, dtype=S.dtype, device=S.device)
    for _ in range(_HORN_SQUARINGS):
        # elementwise products and sums: no matmul library, no TF32
        M = (M[..., :, :, None] * M[..., None, :, :]).sum(-2)
        M = M / M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    j = M.diagonal(dim1=-2, dim2=-1).argmax(-1)
    q = torch.take_along_dim(M, j[..., None, None].expand(M.shape[:-1] + (1,)), -1)[..., 0]
    w, x, y, z = (q / torch.sqrt((q * q).sum(-1, keepdim=True))).unbind(-1)
    R = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)
    return torch.where(degenerate, eye, R)


def _rodrigues(axis, cos, sin):
    """Rotation matrices from unit axis (..., 3) and cos/sin (..., 1)."""
    rx, ry, rz = axis[..., 0:1], axis[..., 1:2], axis[..., 2:3]
    zeros = torch.zeros_like(rx)
    K = torch.stack([
        torch.cat([zeros, -rz, ry], dim=-1),
        torch.cat([rz, zeros, -rx], dim=-1),
        torch.cat([-ry, rx, zeros], dim=-1),
    ], dim=-2)
    ident = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return ident + sin[..., None] * K + (1.0 - cos[..., None]) * (K @ K)


def batch_inverse_kinematics(pose_skeleton, phis, rest_pose, leaf_rotmats=None,
                             ignore_outlier: bool = False, outlier_thresh: float = 0.015):
    """Twist-swing IK over the SMPL tree.

    Args:
      pose_skeleton: (B, 24, 3) target global joint positions.
      phis: (B, 23, 2) twist (cos, sin) per non-root joint, any scale
        (normalized here); row j - 1 is joint j's.
      rest_pose: (B, 24, 3) rest (template) joint positions.
      leaf_rotmats: (B, 5, 3, 3) local rotations of the 5 leaf joints
        (toes, head, hands), identity if None.
      ignore_outlier: replace per-bone targets that moved more than
        `outlier_thresh` from the bone-length-normalized observed relative
        positions by the latter.

    Returns (local_rotmats (B,24,3,3), global_rotmats (B,24,3,3),
    global_joints (B,24,3)); the joints are the FK of the solution, rooted at
    rest_pose[:, 0].
    """
    B = pose_skeleton.shape[0]
    dtype, dev = pose_skeleton.dtype, pose_skeleton.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    if leaf_rotmats is None:
        leaf_rotmats = eye.expand(B, 5, 3, 3)

    tab = _tables(dev)
    par_all = tab["parents"]
    # bone vectors relative to the parent; the root entry is the root's
    # rest position
    rel_rest = torch.cat([rest_pose[:, :1], rest_pose[:, 1:] - rest_pose[:, par_all]], dim=1)
    rel_pose = torch.cat([rel_rest[:, :1], pose_skeleton[:, 1:] - pose_skeleton[:, par_all]],
                         dim=1)
    # the target skeleton re-rooted at the rest root
    final_pose = pose_skeleton - pose_skeleton[:, 0:1] + rel_rest[:, 0:1]

    phis = phis / (_safe_norm(phis) + _EPS)

    # per joint: global rotation, local rotation, FK position
    chain, local, joints = [None] * 24, [None] * 24, [None] * 24
    joints[0] = rel_rest[:, 0]
    pelvis_ch = slice(PELVIS_CHILDREN[0], PELVIS_CHILDREN[-1] + 1)
    R0 = _kabsch(rel_rest[:, pelvis_ch].transpose(1, 2), rel_pose[:, pelvis_ch].transpose(1, 2))
    chain[0] = local[0] = R0

    leaf_slot = {j: i for i, j in enumerate(LEAF_JOINTS)}
    spine_ch = slice(SPINE_CHILDREN[0], SPINE_CHILDREN[-1] + 1)
    for level, (idx, ch, phi_rows) in zip(IK_LEVELS[1:], tab["levels"]):
        par = [_PARENTS[j] for j in level]
        chain_par = torch.stack([chain[p] for p in par], dim=1)           # (B, k, 3, 3)
        # place this level's joints by rotating their rest bones
        placed = torch.stack([joints[p] for p in par], dim=1) + torch.einsum(
            "bkij,bkj->bki", chain_par, rel_rest.index_select(1, idx))

        if level == IK_LEVELS[-1]:
            rot = torch.stack([leaf_rotmats[:, leaf_slot[j]] for j in level], dim=1)
        elif level == [SPINE_JOINT]:
            # 3-child Procrustes fit in the parent frame, a constant of the data
            tgt = final_pose[:, spine_ch] - placed[:, 0:1]
            tgt = torch.einsum("bji,bkj->bki", chain[_PARENTS[SPINE_JOINT]], tgt).detach()
            rst = rel_rest[:, spine_ch]
            rot = _kabsch(rst.transpose(1, 2), tgt.transpose(1, 2))[:, None]
        else:
            # desired child offset, rotated back into this joint's frame
            rel_opt = final_pose.index_select(1, ch) - placed
            child_rest = rel_rest.index_select(1, ch)
            if ignore_outlier:
                orig = rel_pose.index_select(1, ch)
                orig = orig * _safe_norm(child_rest) / (_safe_norm(orig) + _EPS)
                diff = _safe_norm(rel_opt - orig)
                rel_opt = torch.where(diff > outlier_thresh, orig, rel_opt)
            child_final = torch.einsum("bkji,bkj->bki", chain_par, rel_opt)

            f_norm = _safe_norm(child_final)
            r_norm = _safe_norm(child_rest)
            axis = torch.linalg.cross(child_rest, child_final, dim=-1)
            a_norm = _safe_norm(axis)
            cos = (child_rest * child_final).sum(-1, keepdim=True) / (r_norm * f_norm + _EPS)
            sin = a_norm / (r_norm * f_norm + _EPS)
            swing = _rodrigues(axis / (a_norm + _EPS), cos, sin)

            spin_axis = child_rest / (r_norm + _EPS)
            pc = phis.index_select(1, phi_rows)       # phi rows are indexed by joint - 1
            twist = _rodrigues(spin_axis, pc[..., 0:1], pc[..., 1:2])
            rot = swing @ twist

        glob = chain_par @ rot
        for k, j in enumerate(level):
            chain[j], local[j], joints[j] = glob[:, k], rot[:, k], placed[:, k]

    return torch.stack(local, dim=1), torch.stack(chain, dim=1), torch.stack(joints, dim=1)


def batch_inverse_kinematics_naive(pose_skeleton, phis, rest_pose, leaf_rotmats=None):
    """Naive variant: per-bone swing from the observed relative bone vectors
    without re-anchoring to the FK chain (threshold 0: the observed vectors
    always win)."""
    local, chain, _ = batch_inverse_kinematics(pose_skeleton, phis, rest_pose, leaf_rotmats,
                                               ignore_outlier=True, outlier_thresh=0.0)
    return local, chain


def perform_context_ik(body_pos_smpl, rest_pose, phis=None, leaf_rot6d=None):
    """The context pipeline's IK: re-roots the targets at the rest root,
    adds the twist residuals to the identity twist [1, 0] and the leaf rot6d
    residuals to the identity 6d, and returns (local rotmats, global rotmats,
    joints at the targets' root).

    body_pos_smpl: (B, 24, 3) SMPL-order joint positions.
    phis: optional (B, 46) or (B, 23, 2) twist residuals.
    leaf_rot6d: optional (B, 30) or (B, 5, 6) leaf rotation residuals.
    """
    B = body_pos_smpl.shape[0]
    tab = _tables(body_pos_smpl.device)
    ident2 = tab["ident2"].to(body_pos_smpl.dtype)
    phis = ident2.expand(B, 23, 2) if phis is None else phis.reshape(B, 23, 2) + ident2
    leaf_rotmats = None
    if leaf_rot6d is not None:
        ident6 = tab["ident6"].to(body_pos_smpl.dtype)
        leaf_rotmats = R.rot6d_to_rotmat(leaf_rot6d.reshape(B, 5, 6) + ident6)

    root_diff = rest_pose[:, 0:1] - body_pos_smpl[:, 0:1]
    local, chain, joints = batch_inverse_kinematics(body_pos_smpl + root_diff, phis, rest_pose,
                                                    leaf_rotmats)
    return local, chain, joints - root_diff
