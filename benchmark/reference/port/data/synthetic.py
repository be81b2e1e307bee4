"""Synthetic motion generation for tests and data-free development.

Counterpart of ``vid2player3d_tpu/data/synthetic.py``: smooth, kinematically
plausible humanoid motion on the mujoco-ordered skeleton (standing root with
gentle sway/drift + sinusoidal joint swings). Every draw comes from numpy's
seeded ``RandomState``, so the port rebuilds the JAX package's library.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import quat as Q
from ..core import smpl as S
from ..core.skeleton import SkeletonMotion
from ..physics.asset import BASE_ROT_XYZW, min_verts_height
from ..utils.runtime import resolve_device
from .amass import build_motion_lib, humanoid_skeleton_tree
from .motion_lib import MotionLib


def make_synthetic_motion(smpl_model: S.SMPLModel, betas: np.ndarray,
                          T: int = 90, fps: float = 30.0, seed: int = 0,
                          amplitude: float = 0.25, root_h: Optional[float] = None,
                          walk_speed: float = 0.4) -> dict:
    """One synthetic clip on the given body shape → entry dict for build_motion_lib."""
    rng = np.random.RandomState(seed)
    tree = humanoid_skeleton_tree(smpl_model, betas)

    t = np.arange(T) / fps
    # per-joint sinusoid in exp-map space (small, smooth, phase-shifted)
    freqs = rng.uniform(0.5, 1.5, size=(23, 3))
    phases = rng.uniform(0, 2 * np.pi, size=(23, 3))
    amps = rng.uniform(0.2, 1.0, size=(23, 3)) * amplitude
    aa = amps[None] * np.sin(2 * np.pi * freqs[None] * t[:, None, None] + phases[None])
    joint_q = Q.exp_map_to_quat(torch.from_numpy(aa.astype(np.float32))).numpy()

    # root: base rotation + slow heading wander
    heading = 0.15 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 2 * np.pi))
    hq = Q.quat_from_angle_axis(torch.from_numpy(heading.astype(np.float32)),
                                torch.tensor([0.0, 0, 1.0]).repeat(T, 1))
    base = torch.from_numpy(np.tile(BASE_ROT_XYZW, (T, 1)))
    root_q = Q.quat_mul(hq, base).numpy()

    if root_h is None:
        root_h = -float(min_verts_height(smpl_model, betas[None])[0]) + 0.02

    root_t = np.zeros((T, 3), dtype=np.float32)
    root_t[:, 0] = walk_speed * t
    root_t[:, 1] = 0.05 * np.sin(2 * np.pi * 0.5 * t)
    root_t[:, 2] = root_h + 0.03 * np.sin(2 * np.pi * 0.8 * t)

    local_rot = np.concatenate([root_q[:, None], joint_q], axis=1).astype(np.float32)
    motion = SkeletonMotion(tree=tree, local_rotation=local_rot,
                            root_translation=root_t, fps=fps)

    gender_beta = np.concatenate([[0.0], betas]).astype(np.float32)
    # min height of the skeleton joints through the motion (cheap proxy)
    min_h = float(motion.global_translation[..., 2].min()) - 0.05
    return dict(motion=motion, motion_body=gender_beta, body_scale=1.0,
                min_verts_h=min_h)


def make_synthetic_motion_lib(num_motions: int = 4, T: int = 90, fps: float = 30.0,
                              seed: int = 0, smpl_model: Optional[S.SMPLModel] = None,
                              beta_scale: float = 0.5, device=None) -> MotionLib:
    """A small MotionLib of varied synthetic motions on varied body shapes,
    on `device` (the card unless given; raises when there is none)."""
    device = resolve_device(device)
    if smpl_model is None:
        smpl_model = S.make_synthetic_smpl()
    rng = np.random.RandomState(seed)
    entries = []
    for i in range(num_motions):
        betas = (rng.randn(10) * beta_scale).astype(np.float32)
        entries.append(make_synthetic_motion(smpl_model, betas, T=T, fps=fps, seed=seed + i))
    return build_motion_lib(entries, device=device)
