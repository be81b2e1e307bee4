"""SMPL body model as linear blend skinning (PyTorch).

Counterpart of ``vid2player3d_tpu/core/smpl.py``: the joint tables, the
loader of the standard SMPL pkl, the deterministic synthetic body that tests
and data-free machines use, and the LBS forward (betas → shaped template →
joint regression → posing) that the asset compiler calls. The tables are
declared here again, not imported.

Joint order is SMPL bone order; quats xyzw; pose is 24×3 axis-angle (72-dim).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from . import rot as R

SMPL_BONE_ORDER_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# MuJoCo humanoid joint order used by the simulator assets.
MUJOCO_JOINT_NAMES = [
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe", "R_Hip", "R_Knee",
    "R_Ankle", "R_Toe", "Torso", "Spine", "Chest", "Neck", "Head", "L_Thorax",
    "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand", "R_Thorax", "R_Shoulder",
    "R_Elbow", "R_Wrist", "R_Hand",
]
SMPL_2_MUJOCO = np.array([SMPL_BONE_ORDER_NAMES.index(n) for n in MUJOCO_JOINT_NAMES], dtype=np.int32)
MUJOCO_2_SMPL = np.array([MUJOCO_JOINT_NAMES.index(n) for n in SMPL_BONE_ORDER_NAMES], dtype=np.int32)

NUM_JOINTS = 24


def smpl_children_map(parents: np.ndarray = SMPL_PARENTS) -> np.ndarray:
    """First-child map of the twist-swing IK: children[j] = the first child
    of j, except Pelvis -> Torso (3) and Chest (9) -> Neck; -1 for a leaf."""
    children = -np.ones_like(parents)
    for i in range(len(parents)):
        p = int(parents[i])
        if p != -1 and children[p] < 0:
            children[p] = i
    children[0] = 3
    children[9] = SMPL_BONE_ORDER_NAMES.index("Neck")
    return children


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL parameters as float32 tensors."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, B)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    posedirs: Optional[torch.Tensor]  # (V, 3, 207) or None

    @property
    def num_verts(self):
        return self.v_template.shape[0]


def load_smpl_pkl(path: str) -> SMPLModel:
    """Load a standard SMPL pkl (basicmodel_*.pkl) into float32 tensors:
    scipy sparse leaves are densified, the first 10 shape directions kept."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def dense(x):
        if hasattr(x, "todense"):
            x = np.asarray(x.todense())
        return np.asarray(x, dtype=np.float32)

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    return SMPLModel(
        v_template=tensor(dense(data["v_template"])),
        shapedirs=tensor(dense(data["shapedirs"])[..., :10]),
        J_regressor=tensor(dense(data["J_regressor"])),
        lbs_weights=tensor(dense(data["weights"])),
        posedirs=tensor(dense(data["posedirs"])) if "posedirs" in data else None,
    )


def make_synthetic_smpl(num_verts: int = 384, seed: int = 0) -> SMPLModel:
    """Deterministic structure-compatible body model for tests / data-free
    machines: a plausible humanoid rest skeleton (y-up, like real SMPL) with
    vertices scattered around the joints and distance-based skinning weights.
    Seeded by numpy, so it equals the JAX package's synthetic body."""
    rng = np.random.RandomState(seed)

    joints = np.array([
        [0.00, 0.00, 0.00],    # Pelvis
        [0.08, -0.08, 0.00],   # L_Hip
        [-0.08, -0.08, 0.00],  # R_Hip
        [0.00, 0.12, 0.00],    # Torso
        [0.10, -0.48, 0.00],   # L_Knee
        [-0.10, -0.48, 0.00],  # R_Knee
        [0.00, 0.25, 0.00],    # Spine
        [0.10, -0.88, -0.02],  # L_Ankle
        [-0.10, -0.88, -0.02], # R_Ankle
        [0.00, 0.32, 0.00],    # Chest
        [0.11, -0.94, 0.10],   # L_Toe
        [-0.11, -0.94, 0.10],  # R_Toe
        [0.00, 0.50, 0.00],    # Neck
        [0.07, 0.42, 0.00],    # L_Thorax
        [-0.07, 0.42, 0.00],   # R_Thorax
        [0.00, 0.60, 0.03],    # Head
        [0.17, 0.42, 0.00],    # L_Shoulder
        [-0.17, 0.42, 0.00],   # R_Shoulder
        [0.42, 0.40, 0.00],    # L_Elbow
        [-0.42, 0.40, 0.00],   # R_Elbow
        [0.66, 0.40, 0.00],    # L_Wrist
        [-0.66, 0.40, 0.00],   # R_Wrist
        [0.74, 0.40, 0.00],    # L_Hand
        [-0.74, 0.40, 0.00],   # R_Hand
    ], dtype=np.float32)

    per_joint = num_verts // NUM_JOINTS
    verts, w_rows = [], []
    for j in range(NUM_JOINTS):
        verts.append(joints[j] + rng.randn(per_joint, 3).astype(np.float32) * 0.05)
        w = np.zeros((per_joint, NUM_JOINTS), dtype=np.float32)
        w[:, j] = 0.8
        p = int(SMPL_PARENTS[j])
        if p >= 0:
            w[:, p] = 0.2
        else:
            w[:, j] = 1.0
        w_rows.append(w)
    rem = num_verts - per_joint * NUM_JOINTS
    if rem:
        verts.append(joints[0] + rng.randn(rem, 3).astype(np.float32) * 0.05)
        w = np.zeros((rem, NUM_JOINTS), dtype=np.float32)
        w[:, 0] = 1.0
        w_rows.append(w)
    v_template = np.concatenate(verts, 0)
    lbs_weights = np.concatenate(w_rows, 0)
    lbs_weights /= lbs_weights.sum(-1, keepdims=True)

    # each joint = mean of its own vertices
    J_reg = np.zeros((NUM_JOINTS, num_verts), dtype=np.float32)
    for j in range(NUM_JOINTS):
        J_reg[j, j * per_joint:(j + 1) * per_joint] = 1.0 / per_joint
    shapedirs = (rng.randn(num_verts, 3, 10) * 0.01).astype(np.float32)

    return SMPLModel(
        v_template=torch.from_numpy(v_template),
        shapedirs=torch.from_numpy(shapedirs),
        J_regressor=torch.from_numpy(J_reg),
        lbs_weights=torch.from_numpy(lbs_weights),
        posedirs=None,
    )


def find_smpl_model(data_dir: str = "data/smpl", gender: str = "neutral") -> SMPLModel:
    """Load real SMPL weights if present, else the synthetic body."""
    names = {
        "neutral": ["SMPL_NEUTRAL.pkl", "basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl",
                    "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"],
        "male": ["SMPL_MALE.pkl", "basicmodel_m_lbs_10_207_0_v1.1.0.pkl"],
        "female": ["SMPL_FEMALE.pkl", "basicmodel_f_lbs_10_207_0_v1.1.0.pkl"],
    }[gender]
    for n in names:
        p = os.path.join(data_dir, n)
        if os.path.exists(p):
            return load_smpl_pkl(p)
    return make_synthetic_smpl()


# ---------------------------------------------------------------------------
# forward model
# ---------------------------------------------------------------------------

def shaped_vertices(model: SMPLModel, betas):
    """betas (..., B) → shaped template vertices (..., V, 3)."""
    return model.v_template + torch.einsum("vcb,...b->...vc", model.shapedirs, betas)


def rest_joints(model: SMPLModel, betas):
    """betas (..., B) → rest joint positions (..., J, 3) in SMPL order."""
    v = shaped_vertices(model, betas)
    return torch.einsum("jv,...vc->...jc", model.J_regressor, v)


# (parents, device, dtype) -> the tree's index tensors and the [0, 0, 0, 1] row
_TREE_TENSORS: dict = {}


def _tree_tensors(parents: np.ndarray, device, dtype):
    """(parent index, has-parent mask (J, 1), the homogeneous row) of a tree
    on a device, made once: a tensor built from host data on every call is
    a host copy, which a step replayed from a CUDA graph cannot hold."""
    key = (tuple(int(p) for p in parents), torch.device(device), dtype)
    hit = _TREE_TENSORS.get(key)
    if hit is None:
        hit = _TREE_TENSORS[key] = (
            torch.as_tensor(np.maximum(parents, 0), dtype=torch.long, device=device),
            torch.as_tensor(parents >= 0, device=device)[:, None],
            torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device))
    return hit


def batch_rigid_transform(rot_mats, joints, parents=SMPL_PARENTS):
    """FK over the SMPL tree with per-joint rotation matrices.

    rot_mats (..., J, 3, 3), joints (..., J, 3) rest positions.
    Returns (posed_joints (..., J, 3), rel_transforms (..., J, 4, 4)).
    """
    parents = np.asarray(parents)
    J = joints.shape[-2]
    par, has_par, bot = _tree_tensors(parents, joints.device, rot_mats.dtype)
    rel = joints - torch.where(has_par, joints[..., par, :], torch.zeros_like(joints))

    def make_T(Rm, t):
        top = torch.cat([Rm, t[..., None]], dim=-1)
        return torch.cat([top, bot.expand(top.shape[:-2] + (1, 4))], dim=-2)

    T_glob = [make_T(rot_mats[..., 0, :, :], rel[..., 0, :])]
    for j in range(1, J):
        T_local = make_T(rot_mats[..., j, :, :], rel[..., j, :])
        T_glob.append(T_glob[int(parents[j])] @ T_local)
    T = torch.stack(T_glob, dim=-3)

    posed = T[..., :3, 3]
    # subtract the skinned contribution of rest joints: T_rel = T - T·[j;0]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    correction = torch.einsum("...jab,...jb->...ja", T, joints_h)
    rel_T = T.clone()
    rel_T[..., :3, 3] = rel_T[..., :3, 3] - correction[..., :3]
    return posed, rel_T


def lbs(model: SMPLModel, betas, pose_aa, trans=None):
    """Full SMPL forward: betas (..., 10), pose_aa (..., 72) → (verts, joints).
    Pose blendshapes are applied only when the model carries posedirs."""
    leading = pose_aa.shape[:-1]
    v_shaped = shaped_vertices(model, betas)
    J = rest_joints(model, betas)
    aa = pose_aa.reshape(leading + (NUM_JOINTS, 3))
    rot_mats = R.angle_axis_to_rotmat(aa)

    if model.posedirs is not None:
        ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feat = (rot_mats[..., 1:, :, :] - ident).reshape(leading + (207,))
        v_shaped = v_shaped + torch.einsum("vcp,...p->...vc", model.posedirs, pose_feat)

    posed_joints, rel_T = batch_rigid_transform(rot_mats, J)
    T = torch.einsum("vj,...jab->...vab", model.lbs_weights, rel_T)
    v_h = torch.cat([v_shaped, torch.ones_like(v_shaped[..., :1])], dim=-1)
    verts = torch.einsum("...vab,...vb->...va", T, v_h)[..., :3]

    if trans is not None:
        verts = verts + trans[..., None, :]
        posed_joints = posed_joints + trans[..., None, :]
    return verts, posed_joints
