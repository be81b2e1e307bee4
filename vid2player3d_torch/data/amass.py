"""Skeleton and motion-library construction for SMPL humanoid motions.

Counterpart of the parts of ``vid2player3d_tpu/data/amass.py`` that the
synthetic motion library needs: the per-shape mujoco-ordered skeleton tree
and the packing of converted clips into a ``MotionLib``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import smpl as S
from ..core.skeleton import SkeletonTree
from ..physics.asset import mujoco_parents
from .motion_lib import MotionLib

# default key bodies for imitation rewards
DEFAULT_KEY_BODIES = ("L_Ankle", "R_Ankle", "L_Wrist", "R_Wrist")


def humanoid_skeleton_tree(smpl_model: S.SMPLModel, betas: np.ndarray,
                           scale: float = 1.0) -> SkeletonTree:
    """Mujoco-ordered skeleton tree for one body shape (betas (10,))."""
    joints = S.rest_joints(smpl_model, torch.from_numpy(np.asarray(betas)[None])).numpy()[0] * scale
    joints_mj = joints[S.SMPL_2_MUJOCO]
    parents = mujoco_parents()
    local_t = np.zeros_like(joints_mj)
    for j in range(1, 24):
        local_t[j] = joints_mj[j] - joints_mj[parents[j]]
    local_t[0] = joints_mj[0]
    return SkeletonTree(tuple(S.MUJOCO_JOINT_NAMES), parents,
                        torch.from_numpy(local_t.astype(np.float32)))


def build_motion_lib(entries: Sequence[dict],
                     key_bodies: Sequence[str] = DEFAULT_KEY_BODIES,
                     device="cpu") -> MotionLib:
    """Pack converted clips (dicts with motion, motion_body, body_scale,
    min_verts_h) into a MotionLib on `device`."""
    return MotionLib.from_motions(
        [e["motion"] for e in entries],
        motion_bodies=np.stack([e["motion_body"] for e in entries]),
        body_scales=np.array([e["body_scale"] for e in entries]),
        min_verts_h=np.array([e["min_verts_h"] for e in entries]),
        key_body_ids=[S.MUJOCO_JOINT_NAMES.index(n) for n in key_bodies],
        device=device,
    )
