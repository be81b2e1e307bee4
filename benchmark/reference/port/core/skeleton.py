"""Skeleton trees and motions (PyTorch counterpart of ``core/skeleton.py``).

``SkeletonTree`` holds node names, parent indices and local (rest)
translations; forward kinematics is a loop over the static tree. Motion
velocities (gaussian-filtered finite differences) are host-side numpy, since
they run once while the motion library is built. Retargeting transfers a
motion between trees through t-pose-relative global rotations.

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

    @property
    def num_joints(self) -> int:
        return len(self.node_names)

    def index(self, name: str) -> int:
        return self.node_names.index(name)

    def to_dict(self):
        return {
            "node_names": list(self.node_names),
            "parent_indices": np.asarray(self.parent_indices).tolist(),
            "local_translation": torch.as_tensor(self.local_translation).cpu().numpy().tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            tuple(d["node_names"]),
            np.asarray(d["parent_indices"], dtype=np.int32),
            torch.from_numpy(np.asarray(d["local_translation"], dtype=np.float32)),
        )


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


def global_to_local_rot(tree: SkeletonTree, global_rot):
    """Inverse of FK rotation composition: global → local rotations."""
    parents = np.asarray(tree.parent_indices)
    locals_: List = [global_rot[..., 0, :]]
    for j in range(1, len(parents)):
        p = int(parents[j])
        locals_.append(Q.quat_mul_norm(Q.quat_inverse(global_rot[..., p, :]),
                                       global_rot[..., j, :]))
    return torch.stack(locals_, dim=-2)


def _f32(x) -> torch.Tensor:
    """A host array as a float32 CPU tensor: the host math runs in float32
    where the JAX package's `jnp.asarray` (x64 off) makes it so."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


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
                self.tree, _f32(self.local_rotation), _f32(self.root_translation))
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

    def to_dict(self):
        return {
            "tree": self.tree.to_dict(),
            "local_rotation": self.local_rotation,
            "root_translation": self.root_translation,
            "fps": self.fps,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            tree=SkeletonTree.from_dict(d["tree"]),
            local_rotation=np.asarray(d["local_rotation"], dtype=np.float32),
            root_translation=np.asarray(d["root_translation"], dtype=np.float32),
            fps=float(d["fps"]),
        )


def compute_velocity(p: np.ndarray, time_delta: float) -> np.ndarray:
    """Gaussian-filtered (sigma=2) central-difference velocity along axis 0."""
    v = np.gradient(np.asarray(p), axis=0) / time_delta
    return gaussian_filter1d(v, 2, axis=0, mode="nearest").astype(np.float32)


def compute_angular_velocity(r: np.ndarray, time_delta: float) -> np.ndarray:
    """Angular velocity from frame-to-frame quaternion differences,
    gaussian-filtered."""
    r = _f32(r)
    dq = Q.quat_mul_norm(r[1:], Q.quat_inverse(r[:-1]))
    angle, axis = Q.quat_to_angle_axis(dq)
    av = (axis * angle[..., None]).numpy() / time_delta
    av = np.concatenate([av, np.zeros_like(av[:1])], axis=0)
    return gaussian_filter1d(av, 2, axis=0, mode="nearest").astype(np.float32)


# ---------------------------------------------------------------------------
# retargeting
# ---------------------------------------------------------------------------

def retarget_motion_by_tpose(
    motion: SkeletonMotion,
    source_tpose_local_rot: np.ndarray,
    target_tree: SkeletonTree,
    target_tpose_local_rot: np.ndarray,
    joint_mapping: dict,
    rotation_to_target: np.ndarray,
    scale_to_target: float,
) -> SkeletonMotion:
    """Transfer a motion between skeletons via t-pose-relative global rotations.

    For each mapped joint: R_target_global = R_align · R_src_global · R_src_tpose^-1 · R_tgt_tpose,
    root translation scaled by `scale_to_target` and rotated by `rotation_to_target`.
    Runs on the host in float32; unmapped target joints keep their t-pose
    global rotation.
    """
    zero = torch.zeros((1, 3))
    tp_rot = fk_local_to_global(motion.tree, _f32(source_tpose_local_rot)[None], zero)[0][0]
    tgt_tp_rot = fk_local_to_global(target_tree, _f32(target_tpose_local_rot)[None], zero)[0][0]

    T = motion.num_frames
    align = _f32(rotation_to_target)
    tgt_global = tgt_tp_rot.expand(T, -1, -1).clone()
    for src_name, tgt_name in joint_mapping.items():
        si = motion.tree.index(src_name)
        ti = target_tree.index(tgt_name)
        rel = Q.quat_mul_norm(_f32(motion.global_rotation[:, si]), Q.quat_inverse(tp_rot[si]))
        rel = Q.quat_mul_norm(align.expand(rel.shape), rel)
        tgt_global[:, ti] = Q.quat_mul_norm(rel, tgt_tp_rot[ti])

    local_rot = global_to_local_rot(target_tree, tgt_global).numpy()
    root_t = Q.quat_rotate(align.expand(T, 4), _f32(motion.root_translation)).numpy() \
        * scale_to_target
    return SkeletonMotion(tree=target_tree, local_rotation=local_rot.astype(np.float32),
                          root_translation=root_t.astype(np.float32), fps=motion.fps)
