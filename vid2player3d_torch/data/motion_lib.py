"""Device-resident motion database (PyTorch counterpart of ``data/motion_lib.py``).

All motion clips are concatenated into flat tensors on the device; sampling
and the bilinear frame-blend + SLERP state lookup are plain functions on
tensors. The frame layout matches the JAX package: gts/grs/lrs concatenated
over motions with `length_starts` offsets; dofs are the per-joint exp map of
the blended local rotations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import quat as Q
from ..core.skeleton import SkeletonMotion


@dataclasses.dataclass(frozen=True)
class MotionLib:
    """Concatenated motion tensors + per-motion metadata, all on one device."""

    gts: torch.Tensor            # (F, J, 3) global body translations
    grs: torch.Tensor            # (F, J, 4) global body rotations
    lrs: torch.Tensor            # (F, J, 4) local joint rotations
    grvs: torch.Tensor           # (F, 3) global root linear velocity
    gravs: torch.Tensor          # (F, 3) global root angular velocity
    dvs: torch.Tensor            # (F, D) dof velocities
    length_starts: torch.Tensor  # (M,) int64 frame offset per motion
    motion_lengths: torch.Tensor  # (M,) seconds
    motion_num_frames: torch.Tensor  # (M,) int32
    motion_dt: torch.Tensor      # (M,)
    motion_weights: torch.Tensor  # (M,) normalized sampling weights
    motion_bodies: torch.Tensor  # (M, 11) gender + betas
    motion_body_scales: torch.Tensor  # (M,)
    motion_min_verts_h: torch.Tensor  # (M,)
    key_body_ids: torch.Tensor   # (K,) int64

    @property
    def num_motions(self) -> int:
        return self.length_starts.shape[0]

    @property
    def num_bodies(self) -> int:
        return self.gts.shape[1]

    @property
    def num_dof(self) -> int:
        return self.dvs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.gts.device

    def to(self, device) -> "MotionLib":
        return MotionLib(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @classmethod
    def from_motions(cls, motions: Sequence[SkeletonMotion],
                     motion_bodies: Optional[np.ndarray] = None,
                     body_scales: Optional[np.ndarray] = None,
                     min_verts_h: Optional[np.ndarray] = None,
                     weights: Optional[np.ndarray] = None,
                     key_body_ids: Sequence[int] = (),
                     device="cpu") -> "MotionLib":
        M = len(motions)
        nf = np.array([m.num_frames for m in motions], dtype=np.int32)
        starts = np.concatenate([[0], np.cumsum(nf)[:-1]]).astype(np.int64)
        dts = np.array([1.0 / m.fps for m in motions], dtype=np.float32)
        lengths = (nf - 1) * dts

        if weights is None:
            weights = np.ones(M, dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        weights = weights / weights.sum()
        if motion_bodies is None:
            motion_bodies = np.zeros((M, 11), dtype=np.float32)
        if body_scales is None:
            body_scales = np.ones(M, dtype=np.float32)
        if min_verts_h is None:
            min_verts_h = np.zeros(M, dtype=np.float32)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        def cat(name):
            return f32(np.concatenate([getattr(m, name) for m in motions], 0))

        return cls(
            gts=cat("global_translation"), grs=cat("global_rotation"),
            lrs=cat("local_rotation"),
            grvs=f32(np.concatenate([m.global_root_velocity for m in motions], 0)),
            gravs=f32(np.concatenate([m.global_root_angular_velocity for m in motions], 0)),
            dvs=f32(np.concatenate([_dof_vels(m) for m in motions], 0)),
            length_starts=torch.as_tensor(starts, device=device),
            motion_lengths=f32(lengths),
            motion_num_frames=torch.as_tensor(nf, device=device),
            motion_dt=f32(dts),
            motion_weights=f32(weights),
            motion_bodies=f32(motion_bodies),
            motion_body_scales=f32(body_scales),
            motion_min_verts_h=f32(min_verts_h),
            key_body_ids=torch.as_tensor(np.asarray(key_body_ids, dtype=np.int64),
                                         device=device),
        )


def _dof_vels(m: SkeletonMotion) -> np.ndarray:
    """Per-frame dof velocities from local-rotation finite differences
    (all-spherical joints → child-frame rotvec rate)."""
    lr = torch.from_numpy(np.asarray(m.local_rotation))  # (T, J, 4)
    dt = 1.0 / m.fps
    dq = Q.quat_mul_norm(Q.quat_inverse(lr[:-1]), lr[1:])
    angle, axis = Q.quat_to_angle_axis(dq)
    vel = axis * angle[..., None] / dt              # (T-1, J, 3)
    vel = torch.cat([vel, vel[-1:]], dim=0)         # repeat last
    return vel[:, 1:].reshape(vel.shape[0], -1).numpy()  # drop root


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_motions(lib: MotionLib, n: int, generator: torch.Generator,
                   weights_from_length: bool = True):
    """n motion ids drawn with replacement, weighted by motion length (or by
    the library's weights), from `generator` (which lives on lib's device)."""
    if weights_from_length:
        w = lib.motion_lengths / lib.motion_lengths.sum()
    else:
        w = lib.motion_weights
    return torch.multinomial(w, n, replacement=True, generator=generator)


def sample_time(lib: MotionLib, motion_ids, truncate_time: Optional[float] = None,
                generator: Optional[torch.Generator] = None, phase=None):
    """Uniform reference times in each motion. `phase` (uniform draws in
    [0, 1), shaped like motion_ids) is drawn from `generator` unless given."""
    if phase is None:
        phase = torch.rand(motion_ids.shape, generator=generator, device=lib.device)
    lens = lib.motion_lengths[motion_ids]
    if truncate_time is not None:
        lens = torch.clamp_min(lens - truncate_time, 0.0)
    return phase * lens


# ---------------------------------------------------------------------------
# state lookup
# ---------------------------------------------------------------------------

def _calc_frame_blend(time, length, num_frames, dt):
    phase = torch.clamp(time / torch.clamp_min(length, 1e-6), 0.0, 1.0)
    f0 = (phase * (num_frames - 1)).to(torch.int64)
    f1 = torch.minimum(f0 + 1, (num_frames - 1).to(torch.int64))
    blend = (time - f0 * dt) / torch.clamp_min(dt, 1e-9)
    return f0, f1, torch.clamp(blend, 0.0, 1.0)


def get_motion_state(lib: MotionLib, motion_ids, motion_times,
                     adjust_height: bool = True, ground_tolerance: float = 0.0):
    """Blended motion state at (motion, time): a dict with root_pos,
    root_rot, dof_pos, root_vel, root_ang_vel, dof_vel, key_pos, rb_pos,
    rb_rot."""
    lens = lib.motion_lengths[motion_ids]
    nf = lib.motion_num_frames[motion_ids]
    dt = lib.motion_dt[motion_ids]
    f0, f1, blend = _calc_frame_blend(motion_times, lens, nf, dt)
    f0l = f0 + lib.length_starts[motion_ids]
    f1l = f1 + lib.length_starts[motion_ids]
    b = blend[..., None]

    root_pos = (1 - b) * lib.gts[f0l, 0] + b * lib.gts[f1l, 0]
    root_rot = Q.slerp(lib.grs[f0l, 0], lib.grs[f1l, 0], b)
    root_vel = lib.grvs[f0l]
    root_ang_vel = lib.gravs[f0l]
    dof_vel = lib.dvs[f0l]

    be = b[..., None]
    local_rot = Q.slerp(lib.lrs[f0l], lib.lrs[f1l], be)
    dof_pos = Q.quat_to_exp_map(local_rot[:, 1:]).reshape(local_rot.shape[0], -1)

    rb_pos = (1 - be) * lib.gts[f0l] + be * lib.gts[f1l]
    rb_rot = Q.slerp(lib.grs[f0l], lib.grs[f1l], be)

    if adjust_height:
        min_vh = lib.motion_min_verts_h[motion_ids] - ground_tolerance
        root_pos = torch.cat([root_pos[..., :2], root_pos[..., 2:] - min_vh[..., None]], -1)
        rb_pos = torch.cat([rb_pos[..., :2], rb_pos[..., 2:] - min_vh[..., None, None]], -1)

    key_pos = rb_pos[:, lib.key_body_ids]

    return dict(root_pos=root_pos, root_rot=root_rot, dof_pos=dof_pos,
                root_vel=root_vel, root_ang_vel=root_ang_vel, dof_vel=dof_vel,
                key_pos=key_pos, rb_pos=rb_pos, rb_rot=rb_rot)
