"""AMASS → MotionLib conversion (PyTorch counterpart of ``data/amass.py``).

Converts SMPL pose sequences (pose_aa (T,72), trans (T,3), betas, gender)
into `SkeletonMotion`s on the per-shape mujoco-ordered skeleton and packs
them into a `MotionLib`. The conversion (exp map, FK, LBS for the lowest
vertex) runs on the host in float32, as in the JAX package; the library
lands on the requested device. No MJCF files, no simulator assets.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import quat as Q
from ..core import smpl as S
from ..core.skeleton import SkeletonMotion, SkeletonTree
from ..physics.asset import mujoco_parents
from ..utils.runtime import resolve_device
from .motion_lib import MotionLib

# default key bodies for imitation rewards
DEFAULT_KEY_BODIES = ("L_Ankle", "R_Ankle", "L_Wrist", "R_Wrist")


def humanoid_skeleton_tree(smpl_model: S.SMPLModel, betas: np.ndarray,
                           scale: float = 1.0) -> SkeletonTree:
    """Mujoco-ordered skeleton tree for one body shape (betas (10,))."""
    betas = torch.from_numpy(np.asarray(betas, np.float32)[None])
    joints = S.rest_joints(smpl_model, betas).numpy()[0] * scale
    joints_mj = joints[S.SMPL_2_MUJOCO]
    parents = mujoco_parents()
    local_t = np.zeros_like(joints_mj)
    for j in range(1, 24):
        local_t[j] = joints_mj[j] - joints_mj[parents[j]]
    local_t[0] = joints_mj[0]
    return SkeletonTree(tuple(S.MUJOCO_JOINT_NAMES), parents,
                        torch.from_numpy(local_t.astype(np.float32)))


def convert_amass_sequence(
    smpl_model: S.SMPLModel,
    pose_aa: np.ndarray,      # (T, 72) axis-angle, SMPL joint order
    trans: np.ndarray,        # (T, 3) world translation (z-up AMASS frame)
    betas: np.ndarray,        # (10,)
    gender: str = "neutral",
    fps: float = 30.0,
    body_scale: float = 1.0,
    min_verts_frames: int = 16,
) -> dict:
    """One AMASS sequence → SkeletonMotion + metadata dict.

    Per-joint exp map → local quats in mujoco order; root = SMPL pelvis
    world pose; min_verts_h = the lowest posed SMPL vertex over
    `min_verts_frames` evenly spaced frames.
    """
    T = pose_aa.shape[0]
    pose_aa = np.asarray(pose_aa, dtype=np.float32).reshape(T, 24, 3)
    trans = np.asarray(trans, dtype=np.float32)
    betas_t = torch.from_numpy(np.asarray(betas, np.float32))

    tree = humanoid_skeleton_tree(smpl_model, betas, body_scale)
    local_q_smpl = Q.exp_map_to_quat(torch.from_numpy(pose_aa)).numpy()  # (T,24,4)
    local_q = local_q_smpl[:, S.SMPL_2_MUJOCO]

    # pelvis world position = rest pelvis + trans (SMPL LBS root convention)
    j0 = tree.local_translation.numpy()[0]
    root_t = trans * body_scale + j0

    motion = SkeletonMotion(tree=tree, local_rotation=local_q.astype(np.float32),
                            root_translation=root_t.astype(np.float32), fps=fps)

    # min world-z over posed vertices, subsampled frames (betas broadcast to
    # the frame batch)
    idx = np.linspace(0, T - 1, min(min_verts_frames, T)).astype(int)
    verts, _ = S.lbs(smpl_model, betas_t.expand(len(idx), 10),
                     torch.from_numpy(pose_aa[idx].reshape(len(idx), 72)),
                     trans=torch.from_numpy(trans[idx] * body_scale))
    min_verts_h = float(verts[..., 2].min())

    gender_code = {"neutral": 0, "male": 1, "female": 2}[gender]
    motion_body = np.concatenate([[gender_code], betas]).astype(np.float32)
    return dict(motion=motion, motion_body=motion_body, body_scale=body_scale,
                min_verts_h=min_verts_h)


def build_motion_lib(entries: Sequence[dict],
                     key_bodies: Sequence[str] = DEFAULT_KEY_BODIES,
                     device=None) -> MotionLib:
    """Pack converted clips (dicts with motion, motion_body, body_scale,
    min_verts_h) into a MotionLib on `device` (the card unless given)."""
    device = resolve_device(device)
    return MotionLib.from_motions(
        [e["motion"] for e in entries],
        motion_bodies=np.stack([e["motion_body"] for e in entries]),
        body_scales=np.array([e["body_scale"] for e in entries]),
        min_verts_h=np.array([e["min_verts_h"] for e in entries]),
        key_body_ids=[S.MUJOCO_JOINT_NAMES.index(n) for n in key_bodies],
        device=device,
    )


def convert_amass_dir(amass_dir: str, smpl_model: Optional[S.SMPLModel] = None,
                      out_path: Optional[str] = None, max_seqs: Optional[int] = None,
                      target_fps: float = 30.0, device=None) -> MotionLib:
    """Convert a directory of AMASS .npz files (searched recursively) into a
    MotionLib on `device` (the card unless given), saved to `out_path` when
    given. Each clip is downsampled by round(fps / target_fps); SMPLH's
    156-dim poses keep the 66 body dims (hands → identity); clips shorter
    than 10 frames after downsampling are dropped, and so is any file that
    fails to load; an unknown gender maps to neutral."""
    device = resolve_device(device)
    if smpl_model is None:
        smpl_model = S.find_smpl_model()
    files = sorted(glob.glob(os.path.join(amass_dir, "**", "*.npz"), recursive=True))
    if max_seqs:
        files = files[:max_seqs]
    entries = []
    for f in files:
        try:
            with np.load(f) as data:
                poses = np.asarray(data["poses"])  # (T, 156) SMPLH or (T,72)
                fps = float(data.get("mocap_framerate", data.get("mocap_frame_rate", 60.0)))
                trans = np.asarray(data["trans"])
                betas = np.asarray(data["betas"])[:10]
                gender = str(data.get("gender", "neutral"))
        except Exception:
            continue
        skip = max(1, int(round(fps / target_fps)))
        poses = poses[::skip]
        trans = trans[::skip]
        if poses.shape[0] < 10:
            continue
        # SMPLH 156-dim → SMPL 72: body pose 63 + root 3, hands → identity
        if poses.shape[1] >= 156:
            pose72 = np.zeros((poses.shape[0], 72), dtype=np.float32)
            pose72[:, :66] = poses[:, :66]
        else:
            pose72 = poses[:, :72].astype(np.float32)
        if gender not in ("neutral", "male", "female"):
            gender = "neutral"
        entries.append(convert_amass_sequence(
            smpl_model, pose72, trans, betas.astype(np.float32), gender,
            fps=fps / skip))
    lib = build_motion_lib(entries, device=device)
    if out_path:
        lib.save(out_path)
    return lib
