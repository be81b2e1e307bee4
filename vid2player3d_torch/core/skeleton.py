"""Skeleton trees and motions (PyTorch counterpart of ``core/skeleton.py``).

``SkeletonTree`` holds node names, parent indices and local (rest)
translations; forward kinematics is a loop over the static tree. Motion
velocities (gaussian-filtered finite differences) are host-side numpy, since
they run once while the motion library is built.

Quaternions are xyzw throughout.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from . import quat as Q


@dataclasses.dataclass(frozen=True)
class SkeletonTree:
    """Static kinematic tree: node names + parent indices + local translations.

    parent_indices[0] == -1 for the root; parents precede their children."""

    node_names: tuple
    parent_indices: np.ndarray  # (J,) int32
    local_translation: torch.Tensor  # (J, 3)

    def index(self, name: str) -> int:
        return self.node_names.index(name)


def fk_local_to_global(tree: SkeletonTree, local_rot, root_translation,
                       local_translation=None):
    """Local joint rotations → global rotations + translations.

    local_rot: (..., J, 4) xyzw; root_translation: (..., 3).
    Returns (global_rot (..., J, 4), global_pos (..., J, 3)) with
    T_global[j] = T_global[parent[j]] ∘ (local_translation[j], local_rot[j]).
    """
    parents = np.asarray(tree.parent_indices)
    lt = tree.local_translation if local_translation is None else local_translation
    J = len(parents)

    g_rot: List = [None] * J
    g_pos: List = [None] * J
    g_rot[0] = local_rot[..., 0, :]
    g_pos[0] = root_translation
    for j in range(1, J):
        p = int(parents[j])
        g_rot[j] = Q.quat_mul_norm(g_rot[p], local_rot[..., j, :])
        offset = lt[..., j, :].expand(g_pos[p].shape)
        g_pos[j] = g_pos[p] + Q.quat_rotate(g_rot[p], offset)
    return torch.stack(g_rot, dim=-2), torch.stack(g_pos, dim=-2)


@dataclasses.dataclass
class SkeletonMotion:
    """A motion clip: local rotations + root translation over time, with
    cached global quantities and filtered velocities (numpy, host side)."""

    tree: SkeletonTree
    local_rotation: np.ndarray  # (T, J, 4) xyzw
    root_translation: np.ndarray  # (T, 3)
    fps: float
    global_rotation: np.ndarray = None  # (T, J, 4)
    global_translation: np.ndarray = None  # (T, J, 3)
    global_velocity: np.ndarray = None  # (T, J, 3)
    global_angular_velocity: np.ndarray = None  # (T, J, 3)

    def __post_init__(self):
        if self.global_rotation is None:
            g_rot, g_pos = fk_local_to_global(
                self.tree, torch.from_numpy(np.asarray(self.local_rotation)),
                torch.from_numpy(np.asarray(self.root_translation)))
            self.global_rotation = g_rot.numpy()
            self.global_translation = g_pos.numpy()
        if self.global_velocity is None:
            self.global_velocity = compute_velocity(self.global_translation, 1.0 / self.fps)
            self.global_angular_velocity = compute_angular_velocity(self.global_rotation, 1.0 / self.fps)

    @property
    def num_frames(self) -> int:
        return self.local_rotation.shape[0]

    @property
    def global_root_velocity(self):
        return self.global_velocity[:, 0]

    @property
    def global_root_angular_velocity(self):
        return self.global_angular_velocity[:, 0]


def compute_velocity(p: np.ndarray, time_delta: float) -> np.ndarray:
    """Gaussian-filtered (sigma=2) central-difference velocity along axis 0."""
    v = np.gradient(np.asarray(p), axis=0) / time_delta
    return gaussian_filter1d(v, 2, axis=0, mode="nearest").astype(np.float32)


def compute_angular_velocity(r: np.ndarray, time_delta: float) -> np.ndarray:
    """Angular velocity from frame-to-frame quaternion differences,
    gaussian-filtered."""
    r = torch.from_numpy(np.asarray(r))
    dq = Q.quat_mul_norm(r[1:], Q.quat_inverse(r[:-1]))
    angle, axis = Q.quat_to_angle_axis(dq)
    av = (axis * angle[..., None]).numpy() / time_delta
    av = np.concatenate([av, np.zeros_like(av[:1])], axis=0)
    return gaussian_filter1d(av, 2, axis=0, mode="nearest").astype(np.float32)
