"""Articulation model and simulation state containers (PyTorch).

Counterpart of ``vid2player3d_tpu/physics/model.py``: a parametric model with
per-env heterogeneous bodies as tensors (betas → offsets, masses, inertias)
and a static structure (parents, contact wiring, self-collision pairs).

The static structure is turned into index tensors on the model's device once,
when the model is built (``Topology``), so a control step never copies
indices from the host.

All per-env quantities carry a leading env axis N.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from ..utils.runtime import resolve_device


def tree_levels(parents: Tuple[int, ...]) -> List[np.ndarray]:
    """Bodies grouped by tree depth: levels[0] == [root]; every body's parent
    lives exactly one level up."""
    depth = [0] * len(parents)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return [np.array([j for j, dj in enumerate(depth) if dj == d], dtype=np.int64)
            for d in range(max(depth) + 1)]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Level plumbing of the static tree as index tensors on the device.

    `levels[d]` = body ids at depth d; `joints[d]` = their joint ids
    (body id − 1); `par_loc[d]` = position of each level-d body's parent
    within level d−1's id list, so parent lookups are gathers from a small
    (L, N) slab. `inv_order`/`inv_joint_order` map level-major packing back
    to body/joint order. Contact bodies and self-collision pairs are
    contact-sphere indices."""

    levels: Tuple[torch.Tensor, ...]
    joints: Tuple[torch.Tensor, ...]
    par_loc: Tuple[torch.Tensor, ...]
    level_sizes: Tuple[int, ...]
    inv_order: torch.Tensor
    inv_joint_order: torch.Tensor
    contact_body: torch.Tensor
    pair_i: torch.Tensor
    pair_j: torch.Tensor
    pair_body_i: torch.Tensor
    pair_body_j: torch.Tensor
    num_pairs: int

    @classmethod
    def build(cls, parents, contact_body, collision_pairs, device):
        parents = np.asarray(parents)
        levels = tree_levels(tuple(int(p) for p in parents))
        pos_in_level = {}
        for ids in levels:
            for k, j in enumerate(ids):
                pos_in_level[int(j)] = k
        par_loc = [np.zeros(1, np.int64)] + [
            np.array([pos_in_level[int(parents[j])] for j in ids], np.int64)
            for ids in levels[1:]]
        body_order = np.concatenate(levels)
        cb = np.asarray(contact_body, np.int64)
        pi = np.asarray([p[0] for p in collision_pairs], np.int64)
        pj = np.asarray([p[1] for p in collision_pairs], np.int64)

        def t(a):
            return torch.as_tensor(a, dtype=torch.long, device=device)

        return cls(
            levels=tuple(t(ids) for ids in levels),
            joints=tuple(t(ids - 1) for ids in levels),
            par_loc=tuple(t(p) for p in par_loc),
            level_sizes=tuple(len(ids) for ids in levels),
            inv_order=t(np.argsort(body_order)),
            inv_joint_order=t(np.argsort(body_order[1:])),
            contact_body=t(cb),
            pair_i=t(pi), pair_j=t(pj),
            pair_body_i=t(cb[pi]), pair_body_j=t(cb[pj]),
            num_pairs=len(pi),
        )


@functools.lru_cache(maxsize=None)
def _topology(parents, contact_body, collision_pairs, device) -> Topology:
    """A tree's `Topology` on `device`, built once: a model made anew (a
    per-epoch randomized copy, a `tree_map` of one) shares its index tensors
    instead of copying them from the host again, which on the card is a
    copy that syncs."""
    return Topology.build(parents, contact_body, collision_pairs, device)


@dataclasses.dataclass(frozen=True)
class ArticulationModel:
    """Reduced-coordinate articulated body: free root + (J-1) spherical joints.

    Static fields:
      parents: tuple of parent body indices, parents[0] == -1
      names:   body names in simulation (mujoco) order
      contact_body: tuple of body ids, one per contact sphere (P)
      collision_pairs: (sphere_i, sphere_j) contact-sphere index pairs checked
        for sphere-sphere penetration each substep; empty = self-collision off
    Tensor fields, leading env axis N:
      joint_pos (N,J,3) joint position in parent frame; body_com (N,J,3) COM
      offset in body frame; body_mass (N,J); body_inertia (N,J,3,3) about COM;
      kp, kd, torque_lim, armature (N,J-1); contact_offset (N,P,3) body-frame
      sphere offsets; contact_radius (N,P).
    """

    parents: Tuple[int, ...]
    names: Tuple[str, ...]
    joint_pos: torch.Tensor
    body_com: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor
    torque_lim: torch.Tensor
    armature: torch.Tensor
    contact_body: Tuple[int, ...]
    contact_offset: torch.Tensor
    contact_radius: torch.Tensor
    collision_pairs: Tuple[Tuple[int, int], ...] = ()
    topo: Topology = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "topo", _topology(
            tuple(int(p) for p in self.parents), tuple(int(c) for c in self.contact_body),
            tuple((int(i), int(j)) for i, j in self.collision_pairs), self.joint_pos.device))

    @property
    def num_bodies(self) -> int:
        return len(self.parents)

    @property
    def num_envs(self) -> int:
        return self.joint_pos.shape[0]

    @property
    def num_dof(self) -> int:
        return 3 * (self.num_bodies - 1)

    @property
    def device(self) -> torch.device:
        return self.joint_pos.device


@dataclasses.dataclass(frozen=True)
class ArticulationState:
    """Generalized-coordinate state, leading env axis N.

    root_pos (N,3) world; root_quat (N,4) xyzw world; root_vel (N,6) spatial
    [ω; v] of the root IN ROOT BODY COORDS at the body origin; joint_quat
    (N,J-1,4) child-relative-to-parent; joint_omega (N,J-1,3) relative angular
    velocity in child coords.
    """

    root_pos: torch.Tensor
    root_quat: torch.Tensor
    root_vel: torch.Tensor
    joint_quat: torch.Tensor
    joint_omega: torch.Tensor

    @classmethod
    def zeros(cls, num_envs: int, num_bodies: int, root_h: float = 1.0,
              device=None) -> "ArticulationState":
        """Rest state in f32 on `device` (the card unless given): root at
        height `root_h` with identity orientation, identity joints, no
        velocity."""
        device = resolve_device(device)
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
        return cls(
            root_pos=torch.tensor([0.0, 0.0, root_h], device=device).repeat(num_envs, 1),
            root_quat=ident.repeat(num_envs, 1),
            root_vel=torch.zeros((num_envs, 6), device=device),
            joint_quat=ident.repeat(num_envs, num_bodies - 1, 1),
            joint_omega=torch.zeros((num_envs, num_bodies - 1, 3), device=device),
        )


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Penalty-contact material parameters."""

    kn: float = 3.0e4       # normal stiffness N/m
    dn: float = 1.2e3       # normal damping  N·s/m
    mu: float = 1.0         # Coulomb friction coefficient
    kt: float = 2.0e3       # tangential damping used for friction regularization
    vt_eps: float = 1e-4


GRAVITY = np.array([0.0, 0.0, -9.81], dtype=np.float32)
