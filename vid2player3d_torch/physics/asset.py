"""Parametric asset compiler: SMPL betas → articulation model tensors.

Counterpart of ``vid2player3d_tpu/physics/asset.py``: the model quantities
(joint offsets, masses, inertias, contact geometry) are computed directly
from the SMPL body with a leading env axis, so heterogeneous bodies share one
code path. Host side (numpy); the result is moved to the requested device.

Bodies are in MuJoCo joint order; PD gains and torque limits follow the
reference's GAINS table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import smpl as S
from ..utils.runtime import resolve_device
from .model import ArticulationModel, ArticulationState

# per-joint [kp, kd, torque_limit]
GAINS = {
    "L_Hip": (500, 50, 500), "L_Knee": (500, 50, 500), "L_Ankle": (400, 40, 500),
    "L_Toe": (200, 20, 500), "R_Hip": (500, 50, 500), "R_Knee": (500, 50, 500),
    "R_Ankle": (400, 40, 500), "R_Toe": (200, 20, 500), "Torso": (1000, 100, 500),
    "Spine": (1000, 100, 500), "Chest": (1000, 100, 500), "Neck": (100, 10, 250),
    "Head": (100, 10, 250), "L_Thorax": (400, 40, 500), "L_Shoulder": (400, 40, 250),
    "L_Elbow": (300, 30, 150), "L_Wrist": (100, 10, 150), "L_Hand": (100, 10, 150),
    "R_Thorax": (400, 40, 150), "R_Shoulder": (400, 40, 250), "R_Elbow": (300, 30, 150),
    "R_Wrist": (100, 10, 150), "R_Hand": (100, 10, 150),
}

HUMAN_DENSITY = 1000.0  # kg/m^3
DEFAULT_HUMANOID_MASS = 90.0

# Body frames ARE the SMPL canonical frames (y-up within a frame); the
# standing humanoid's world root orientation is the fixed base rotation
# [0.5, 0.5, 0.5, 0.5] (xyzw), whose matrix maps body y → world z.
BASE_ROT_XYZW = np.array([0.5, 0.5, 0.5, 0.5], dtype=np.float32)
_R_BASE = np.array([[0.0, 0.0, 1.0],
                    [1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0]], dtype=np.float32)


def smpl_to_world_rest(v: np.ndarray) -> np.ndarray:
    """Rotate SMPL-frame vectors to world frame at the rest (standing) pose."""
    return v @ _R_BASE.T


def default_self_collision_pairs(names) -> tuple:
    """Curated humanoid self-collision pair list (contact-sphere indices;
    sphere j of the first 24 belongs to body j): the arms (elbow/wrist/hand)
    against the trunk and thighs, the two arms against each other, and the
    knees against each other."""
    arms = [f"{s}_{p}" for s in ("L", "R") for p in ("Elbow", "Wrist", "Hand")]
    trunk = ["Torso", "Spine", "Chest", "Head", "L_Hip", "R_Hip",
             "L_Knee", "R_Knee"]
    idx = {n: i for i, n in enumerate(names)}
    pairs = [(idx[a], idx[t]) for a in arms for t in trunk]
    for a in ("L_Elbow", "L_Wrist", "L_Hand"):
        for b in ("R_Elbow", "R_Wrist", "R_Hand"):
            pairs.append((idx[a], idx[b]))
    pairs.append((idx["L_Knee"], idx["R_Knee"]))
    return tuple(pairs)


def mujoco_parents() -> np.ndarray:
    """Parent indices in mujoco body order, derived from SMPL_PARENTS."""
    m2s = S.SMPL_2_MUJOCO
    smpl2mj = np.empty(24, dtype=np.int64)
    smpl2mj[m2s] = np.arange(24)
    parents = np.zeros(24, dtype=np.int32)
    parents[0] = -1
    for mj in range(1, 24):
        parents[mj] = smpl2mj[S.SMPL_PARENTS[m2s[mj]]]
    return parents


def build_humanoid_model(
    smpl_model: S.SMPLModel,
    betas: np.ndarray,
    gender: Optional[np.ndarray] = None,
    scale: Optional[np.ndarray] = None,
    kp_scale: float = 1.0,
    kd_scale: float = 1.0,
    self_collision: bool = False,
    device=None,
) -> ArticulationModel:
    """betas (N, 10) [+ optional per-env scale (N,)] → ArticulationModel with
    per-env joint offsets / masses / inertias / contact spheres on `device`
    (the card unless given). `gender` is accepted in the JAX package's place
    and, as there, not read."""
    device = resolve_device(device)
    betas = np.asarray(betas, dtype=np.float32)
    N = betas.shape[0]
    if scale is None:
        scale = np.ones(N, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)

    # rest joints and shaped vertices, kept in SMPL/body coords (y-up in frame)
    b = torch.from_numpy(betas)
    verts = S.shaped_vertices(smpl_model, b).numpy() * scale[:, None, None]
    joints = S.rest_joints(smpl_model, b).numpy() * scale[:, None, None]

    m2s = S.SMPL_2_MUJOCO
    joints_mj = joints[:, m2s]  # (N,24,3)
    parents_mj = mujoco_parents()

    # joint offsets: child joint position relative to parent joint
    joint_pos = np.zeros_like(joints_mj)
    for j in range(1, 24):
        joint_pos[:, j] = joints_mj[:, j] - joints_mj[:, parents_mj[j]]

    # vertex→bone assignment by max skinning weight (smpl order → mujoco)
    bone_of_vert_smpl = np.argmax(smpl_model.lbs_weights.numpy(), axis=-1)
    smpl2mj = np.empty(24, dtype=np.int64)
    smpl2mj[m2s] = np.arange(24)
    bone_of_vert = smpl2mj[bone_of_vert_smpl]

    body_mass = np.zeros((N, 24), dtype=np.float32)
    body_com = np.zeros((N, 24, 3), dtype=np.float32)
    body_inertia = np.zeros((N, 24, 3, 3), dtype=np.float32)
    geom_radius = np.zeros((N, 24), dtype=np.float32)
    geom_center = np.zeros((N, 24, 3), dtype=np.float32)

    for j in range(24):
        sel = bone_of_vert == j
        if sel.sum() < 4:
            # tiny bodies: nominal point mass at the joint
            body_mass[:, j] = 0.2
            body_inertia[:, j] = np.eye(3) * 1e-4
            geom_radius[:, j] = 0.03
            continue
        pts = verts[:, sel] - joints_mj[:, j:j + 1]  # body-frame points (N,P,3)
        com = pts.mean(axis=1)
        centered = pts - com[:, None]
        cov = np.einsum("npi,npj->nij", centered, centered) / pts.shape[1]
        evals, evecs = np.linalg.eigh(cov)
        semi = np.sqrt(np.maximum(5.0 * evals, 1e-8))  # uniform-ellipsoid fit
        mass = HUMAN_DENSITY * (4.0 / 3.0 * np.pi * semi.prod(axis=-1))
        a2, b2, c2 = semi[:, 0] ** 2, semi[:, 1] ** 2, semi[:, 2] ** 2
        I_p = np.zeros((N, 3, 3), dtype=np.float32)
        I_p[:, 0, 0] = mass / 5.0 * (b2 + c2)
        I_p[:, 1, 1] = mass / 5.0 * (a2 + c2)
        I_p[:, 2, 2] = mass / 5.0 * (a2 + b2)
        body_mass[:, j] = mass
        body_com[:, j] = com
        body_inertia[:, j] = np.einsum("nab,nbc,ndc->nad", evecs, I_p, evecs)
        geom_center[:, j] = com
        geom_radius[:, j] = semi.min(axis=-1)

    # contact spheres: one per body at the geom center, plus heel/ball spheres
    # per foot near the sole ("down" at rest is -y in the SMPL body frame)
    names = tuple(S.MUJOCO_JOINT_NAMES)
    contact_body = list(range(24))
    contact_offset = [geom_center[:, j] for j in range(24)]
    contact_radius = [geom_radius[:, j] for j in range(24)]
    for foot in ("L_Ankle", "R_Ankle"):
        j = names.index(foot)
        toe_dir = joint_pos[:, names.index(foot.split("_")[0] + "_Toe")]
        sole_y = geom_center[:, j, 1] - geom_radius[:, j] * 0.5
        for frac in (-0.35, 0.7):
            off = geom_center[:, j] + frac * toe_dir
            off[:, 1] = sole_y
            contact_body.append(j)
            contact_offset.append(off.astype(np.float32))
            contact_radius.append(np.full(N, 0.02, dtype=np.float32))

    # PD gains in mujoco order, scaled by body mass ratio
    pd_scale = body_mass.sum(axis=1) / DEFAULT_HUMANOID_MASS
    kp = np.zeros((N, 23), dtype=np.float32)
    kd = np.zeros((N, 23), dtype=np.float32)
    torque_lim = np.zeros((N, 23), dtype=np.float32)
    for j in range(1, 24):
        g = GAINS[names[j]]
        kp[:, j - 1] = g[0] * pd_scale * kp_scale
        kd[:, j - 1] = g[1] * pd_scale * kd_scale
        torque_lim[:, j - 1] = g[2]

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ArticulationModel(
        parents=tuple(parents_mj.tolist()),
        names=names,
        collision_pairs=default_self_collision_pairs(names) if self_collision else (),
        joint_pos=t(joint_pos),
        body_com=t(body_com),
        body_mass=t(body_mass),
        body_inertia=t(body_inertia),
        kp=t(kp),
        kd=t(kd),
        torque_lim=t(torque_lim),
        armature=t(np.full((N, 23), 0.02)),
        contact_body=tuple(contact_body),
        contact_offset=t(np.stack(contact_offset, axis=1)),
        contact_radius=t(np.stack(contact_radius, axis=1)),
    )


def min_verts_height(smpl_model: S.SMPLModel, betas: np.ndarray,
                     pose_aa: Optional[np.ndarray] = None) -> np.ndarray:
    """Lowest vertex height of the (rest-posed, or posed by pose_aa) body in
    sim frame."""
    b = torch.from_numpy(np.asarray(betas, dtype=np.float32))
    if pose_aa is None:
        verts = S.shaped_vertices(smpl_model, b).numpy()
    else:
        verts = S.lbs(smpl_model, b, torch.from_numpy(np.asarray(pose_aa, np.float32)))[0].numpy()
    return smpl_to_world_rest(verts)[..., 2].min(axis=-1)


def default_humanoid_state(model: ArticulationModel, num_envs: int,
                           root_h: float = 0.89) -> ArticulationState:
    """Standing rest state on the model's device: identity joints, the root
    at height `root_h` in the base rotation (the SMPL body frame's rest
    orientation in the world)."""
    st = ArticulationState.zeros(num_envs, model.num_bodies, root_h=root_h, device=model.device)
    base = torch.as_tensor(BASE_ROT_XYZW, device=model.device).repeat(num_envs, 1)
    return ArticulationState(st.root_pos, base, st.root_vel, st.joint_quat, st.joint_omega)
