"""Observation builders shared by the env and the policy (PyTorch).

Counterpart of ``vid2player3d_tpu/envs/obs.py``: `compute_imitation_obs` is
the 734-dim imitation observation, used by both the rollout and the training
forward.
"""

from __future__ import annotations

import torch

from ..core import quat as Q


def dof_to_obs(dof_pos):
    """(N, 69) exp-map dofs → (N, 138) tan-norm per joint."""
    N = dof_pos.shape[0]
    q = Q.exp_map_to_quat(dof_pos.reshape(N, -1, 3))
    return Q.quat_to_tan_norm(q).reshape(N, -1)


def compute_imitation_obs(body_pos, body_rot, target_pos, target_rot, dof_pos,
                          dof_vel, target_dof_pos, body_vel, body_ang_vel,
                          motion_bodies):
    """734-dim humanoid imitation observation (local root obs, root height
    obs). body_* (N,24,·) simulated state; target_* reference-motion state;
    motion_bodies (N,11) gender+betas."""
    N = body_pos.shape[0]
    root_pos = body_pos[:, 0]
    root_rot = Q.remove_base_rot(body_rot[:, 0])
    root_h = root_pos[:, 2:3]
    heading_rot, heading = Q.calc_heading_quat_inv_with_heading(root_rot)

    hr = heading_rot[:, None]  # broadcast over bodies

    local_body_pos = Q.quat_rotate(hr, body_pos - root_pos[:, None])
    local_body_pos = local_body_pos.reshape(N, -1)[:, 3:]  # drop root

    local_body_rot = Q.quat_mul(hr.expand(body_rot.shape), body_rot)
    local_body_rot_obs = Q.quat_to_tan_norm(local_body_rot).reshape(N, -1)
    # the reference's local-root-obs quirk: the root entry is the tan-norm of
    # the UN-headinged root_rot
    local_body_rot_obs = torch.cat([Q.quat_to_tan_norm(root_rot), local_body_rot_obs[:, 6:]], -1)

    local_body_vel = Q.quat_rotate(hr, body_vel).reshape(N, -1)
    local_body_ang_vel = Q.quat_rotate(hr, body_ang_vel).reshape(N, -1)

    # --- target relative quantities
    target_root_pos = target_pos[:, 0]
    target_root_rot = Q.remove_base_rot(target_rot[:, 0])
    target_rel_root_h = root_h - target_root_pos[:, 2:3]

    _, target_heading = Q.calc_heading_quat_inv_with_heading(target_root_rot)
    target_rel_root_rot = Q.quat_mul(target_root_rot, Q.quat_conjugate(root_rot))
    target_rel_root_rot_obs = Q.quat_to_tan_norm(target_rel_root_rot)

    target_rel_pos = Q.quat_rotate(heading_rot, target_root_pos - root_pos)
    target_rel_2d_pos = target_rel_pos[:, :2]

    target_rel_heading_vec = Q.heading_to_vec(target_heading - heading)

    target_rel_dof_pos = target_dof_pos - dof_pos

    target_rel_body_pos = Q.quat_rotate(hr, target_pos - body_pos).reshape(N, -1)
    target_rel_body_rot = Q.quat_mul(Q.quat_conjugate(body_rot), target_rot)
    target_rel_body_rot_obs = Q.quat_to_tan_norm(target_rel_body_rot).reshape(N, -1)

    return torch.cat([
        root_h, local_body_pos, local_body_rot_obs, local_body_vel,
        local_body_ang_vel, dof_vel,
        target_rel_root_h, target_rel_root_rot_obs, target_rel_2d_pos,
        target_rel_heading_vec, target_rel_dof_pos, target_rel_body_pos,
        target_rel_body_rot_obs, motion_bodies,
    ], dim=-1)


IMITATION_OBS_DIM = 734  # 24 bodies, 69 dofs, 11 body params
