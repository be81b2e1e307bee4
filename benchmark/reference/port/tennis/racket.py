"""Racket geometry: grip frames and the racket pose from the wrist.

Counterpart of ``vid2player3d_tpu/tennis/racket.py``. A racket is a rigid
extension of the wrist frame: each grip gives a direction and a normal in the
wrist's local frame, and the head center sits at
`wrist + dir * (handle + shaft + head_radius)`.

`racket_from_wrist` takes a simulated world wrist pose; `racket_with_fk`
walks the pelvis→hand chain from kinematic joint rotations.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# SMPL joint indices
PELVIS, TORSO, SPINE, CHEST = 0, 3, 6, 9
L_COLLAR, L_SHOULDER, L_ELBOW, L_WRIST, L_HAND = 13, 16, 18, 20, 22
R_COLLAR, R_SHOULDER, R_ELBOW, R_WRIST, R_HAND = 14, 17, 19, 21, 23

RIGHT_CHAIN = (PELVIS, TORSO, SPINE, CHEST, R_COLLAR, R_SHOULDER, R_ELBOW,
               R_WRIST, R_HAND)
LEFT_CHAIN = (PELVIS, TORSO, SPINE, CHEST, L_COLLAR, L_SHOULDER, L_ELBOW,
              L_WRIST, L_HAND)

_S2 = 1.0 / math.sqrt(2.0)

RACKET_GRIPS: Dict[str, dict] = {
    "eastern": {
        "handle_length": 0.2, "shaft_length": 0.15, "head_radius": 0.15,
        "racket_dir": (-1.0, 0.0, 0.0), "racket_normal": (0.0, 1.0, 0.0),
        "racket_dir_vert": (0.0, 0.0, -1.0),
    },
    "semi_western": {
        "handle_length": 0.2, "shaft_length": 0.15, "head_radius": 0.15,
        "racket_dir": (-1.0, 0.0, 0.0), "racket_normal": (0.0, _S2, _S2),
        "racket_dir_vert": (0.0, _S2, -_S2),
    },
    "lefthand_semi_western": {
        "handle_length": 0.2, "shaft_length": 0.15, "head_radius": 0.15,
        "racket_dir": (1.0, 0.0, 0.0), "racket_normal": (0.0, _S2, _S2),
        "racket_dir_vert": (0.0, _S2, -_S2),
    },
}


def grip_arrays(grip: str = "eastern"):
    """(dir (3,), normal (3,), reach, head_radius) as float32 numpy."""
    g = RACKET_GRIPS[grip]
    reach = g["handle_length"] + g["shaft_length"] + g["head_radius"]
    return (np.asarray(g["racket_dir"], np.float32),
            np.asarray(g["racket_normal"], np.float32), reach,
            g["head_radius"])


def racket_from_wrist(wrist_pos, wrist_rotmat, grip: str = "eastern"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(head_center (...,3), normal (...,3)) from world wrist pose."""
    dir_c, normal_c, reach, _ = grip_arrays(grip)
    rdir = wrist_rotmat @ torch.as_tensor(dir_c, device=wrist_pos.device)
    rnormal = wrist_rotmat @ torch.as_tensor(normal_c, device=wrist_pos.device)
    return wrist_pos + rdir * reach, rnormal


def racket_with_fk(joint_rotmat, joint_pos_bind_rel, root_pos,
                   grip: str = "eastern", righthand: bool = True):
    """FK along pelvis→hand. joint_rotmat (N,J,3,3) local SMPL-order joint
    rotations; joint_pos_bind_rel (N,J,3) bind-pose offsets relative to the
    parent along the chain; root_pos (N,3). Returns the racket head pos,
    normal, dir, head radius and the wrist/hand world positions."""
    chain = list(RIGHT_CHAIN if righthand else LEFT_CHAIN)
    Rm = joint_rotmat[:, chain]
    off = joint_pos_bind_rel[:, chain]

    world_R = Rm[:, 0]
    world_t = off[:, 0]
    for i in range(1, len(chain)):
        world_t = world_t + torch.einsum("nij,nj->ni", world_R, off[:, i])
        world_R = world_R @ Rm[:, i]
        if i == len(chain) - 2:
            wrist_R, wrist_t = world_R, world_t
    hand_t = world_t

    dir_c, normal_c, reach, head_radius = grip_arrays(grip)
    rdir = wrist_R @ torch.as_tensor(dir_c, device=root_pos.device)
    rnormal = wrist_R @ torch.as_tensor(normal_c, device=root_pos.device)
    wrist_world = wrist_t + root_pos
    return {
        "pos": wrist_world + rdir * reach,
        "normal": rnormal,
        "dir": rdir,
        "head_radius": head_radius,
        "wrist_pos": wrist_world,
        "hand_pos": hand_t + root_pos,
    }
