"""Kinematic MVAE player: the high-level policy's motion decoder.

Counterpart of ``vid2player3d_tpu/tennis/player.py``. The player is a
(spec, state) pair: `MVAEPlayerSpec` holds the frozen decoder (an
`nn.Module` here, where the JAX package holds a decode function and its
params) with its normalization stats and per-player behavior tables;
`MVAEPlayerState` is the per-env state the env step threads through.

Per frame (`step`):
  1. decode(z, condition) -> next normalized feature (+ phase sin/cos)
  2. roll the condition window; unnormalize; integrate the root position by
     the predicted root velocity and write it (normalized) back into the
     condition
  3. phase -> [0, 2pi); swing type: the first time the phase enters
     (2.0, 3.5) the wrist x decides forehand (1) / backhand (2); back to -1
     past 3.5
  4. per-player wrist/elbow residual base poses during swing phases, plus
     the policy's residual angles.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import rot as R
from ..utils.runtime import resolve_device
from .racket import L_ELBOW, L_WRIST, R_ELBOW, R_WRIST

# feature layout of the federer-family MVAE recipe
# (root_pos 3 | root_velo 3 | joint_pos 23*3 | joint_velo 23*3 | rot6d 24*6)
ROOT_POS = slice(0, 3)
ROOT_VEL = slice(3, 6)
JOINT_POS = slice(6, 75)
JOINT_VEL = slice(75, 144)
JOINT_ROT6D = slice(144, 288)
FRAME_SIZE = 288

# (field, phase_lo, phase_hi, swing_type, value); fields index
# [elbow_twist, wrist_twist, wrist_shake, wrist_swing] base angles (x pi)
RESIDUAL_TABLES: Dict[str, Tuple[Tuple[int, float, float, int, float], ...]] = {
    "djokovic": (
        (0, 2.0, 3.2, 1, -0.75),   # fh swing: elbow twist
        (3, 2.0, 3.1, 1, -0.25),   # fh pre-contact: wrist swing
        (3, 3.1, 3.2, 1, 0.25),    # fh post-contact: wrist swing
        (0, 2.0, 3.2, 2, -0.25),   # bh swing: elbow twist
        (3, 2.0, 3.0, 2, 0.1),     # bh pre-contact: wrist swing
    ),
    "federer": (
        (0, 2.0, 3.2, 1, -0.5),
        (3, 2.0, 3.1, 1, -0.25),
        (3, 3.1, 3.2, 1, 0.25),
        (1, 2.0, 3.5, 2, -0.25),   # bh: wrist twist (grip change)
        (2, 2.0, 3.5, 2, 0.15),    # bh: wrist shake
        (1, 2.0, 3.5, 3, -0.1),    # bh slice: wrist twist
        (1, 2.0, 3.3, 0, -0.5),    # serve: wrist twist
        (2, 2.0, 3.3, 0, 0.1),     # serve: wrist shake
        (0, 2.0, 3.3, 0, -0.25),   # serve: elbow twist
        (3, 2.0, 3.0, 0, -0.5),    # pre-serve: wrist swing
    ),
    "nadal": (
        (0, 2.5, 3.2, 1, -0.75),
        (3, 2.5, 3.2, 1, 0.25),
        (1, 2.0, 3.5, 2, -0.4),
        (3, 2.0, 3.0, 2, -0.25),
    ),
}


@dataclasses.dataclass(frozen=True)
class MVAEPlayerSpec:
    """Frozen decoder + stats + behavior tables for one player."""
    decoder: torch.nn.Module     # a PoseMixtureVAE; `first_frame` decodes
    avg: torch.Tensor            # (F,) feature normalization stats
    std: torch.Tensor
    player: str = "federer"
    righthand: bool = True
    latent_size: int = 32
    num_condition_frames: int = 1
    residual_scale: float = 0.1
    is_train: bool = True
    predict_phase: bool = True
    num_future_predictions: int = 1

    @property
    def residual_joints(self):
        return (R_ELBOW, R_WRIST) if self.righthand else (L_ELBOW, L_WRIST)

    def decode(self, z, cond):
        """(normalized feature (N, F), phase sin/cos (N, 2)) of the first
        predicted frame."""
        return self.decoder.first_frame(z, cond, self.num_future_predictions,
                                        self.predict_phase)


@dataclasses.dataclass(frozen=True)
class MVAEPlayerState:
    condition: torch.Tensor      # (N, T, F) normalized features
    root_pos: torch.Tensor       # (N, 3)
    root_vel: torch.Tensor       # (N, 3)
    joint_rotmat: torch.Tensor   # (N, 24, 3, 3)
    joint_pos_kin: torch.Tensor  # (N, 23, 3) VAE-predicted joint positions
    phase_pred: torch.Tensor     # (N,) radians in [0, 2pi)
    swing_type: torch.Tensor     # (N,) int32: -1 unk, 0 serve, 1 fh, 2 bh, 3 slice
    swing_type_cycle: torch.Tensor  # (N,) int32 last known swing this cycle


def _unpack(feature):
    """Raw feature -> (root_pos, root_vel, joint_pos (N,23,3), rot6d (N,24,6))."""
    N = feature.shape[0]
    return (feature[:, ROOT_POS], feature[:, ROOT_VEL],
            feature[:, JOINT_POS].reshape(N, 23, 3),
            feature[:, JOINT_ROT6D].reshape(N, 24, 6))


def reset(spec: MVAEPlayerSpec, init_feature_raw, root_xy=None) -> MVAEPlayerState:
    """Init from raw (unnormalized) dataset frames; optionally move the root
    to a sampled court position."""
    N = init_feature_raw.shape[0]
    root_pos, root_vel, joint_pos, rot6d = _unpack(init_feature_raw)
    if root_xy is not None:
        root_pos = torch.cat([root_xy, root_pos[:, 2:]], dim=-1)
        init_feature_raw = torch.cat([root_xy, init_feature_raw[:, 2:]], dim=-1)
    cond = ((init_feature_raw - spec.avg) / spec.std)[:, None]
    cond = cond.repeat(1, spec.num_condition_frames, 1)
    dev = init_feature_raw.device
    return MVAEPlayerState(
        condition=cond, root_pos=root_pos, root_vel=root_vel,
        joint_rotmat=R.rot6d_to_rotmat(rot6d), joint_pos_kin=joint_pos,
        phase_pred=torch.zeros(N, device=dev),
        swing_type=torch.full((N,), -1, dtype=torch.int32, device=dev),
        swing_type_cycle=torch.full((N,), -1, dtype=torch.int32, device=dev))


def step(spec: MVAEPlayerSpec, state: MVAEPlayerState, latents,
         residual: Optional[torch.Tensor] = None) -> MVAEPlayerState:
    """One kinematic frame: decode + integrate + classify + residual pose."""
    N = latents.shape[0]
    feat_norm, phase_sc = spec.decode(latents, state.condition.reshape(N, -1))
    feature = feat_norm * spec.std + spec.avg

    _, root_vel, joint_pos, rot6d = _unpack(feature)
    root_pos = state.root_pos + root_vel
    # the window rolls left; its new last frame is the decoded one with the
    # integrated root written back, normalized
    root_norm = (root_pos - spec.avg[ROOT_POS]) / spec.std[ROOT_POS]
    last = torch.cat([root_norm, feat_norm[:, 3:]], dim=-1)
    condition = torch.cat([state.condition[:, 1:], last[:, None]], dim=1)

    phase = torch.atan2(phase_sc[:, 0], phase_sc[:, 1])
    phase = torch.where(phase < 0, phase + 2 * np.pi, phase)

    # swing-type classification from wrist x at phase entry
    wrist_idx = (R_WRIST if spec.righthand else L_WRIST) - 1
    fh = torch.where(joint_pos[:, wrist_idx, 0] > 0, 1, 2).to(torch.int32)
    if not spec.righthand:
        fh = torch.where(fh == 1, 2, 1).to(torch.int32)
    st = state.swing_type
    st = torch.where((st == -1) & (phase > 2.0) & (phase < 3.5), fh, st)
    st = torch.where((st != -1) & (phase > 3.5), -1, st).to(torch.int32)
    st_cycle = torch.where(st != -1, st, state.swing_type_cycle)

    rotmat = R.rot6d_to_rotmat(rot6d)
    if residual is not None and residual.shape[-1] > 0:
        rotmat = _apply_residual(spec, rotmat, phase, st, residual * spec.residual_scale)

    return MVAEPlayerState(
        condition=condition, root_pos=root_pos, root_vel=root_vel,
        joint_rotmat=rotmat, joint_pos_kin=joint_pos, phase_pred=phase,
        swing_type=st, swing_type_cycle=st_cycle)


def _apply_residual(spec: MVAEPlayerSpec, rotmat, phase, swing_type, res):
    """Per-player elbow/wrist base poses + policy residuals during swing
    phases. Fields: [elbow_twist, wrist_twist, wrist_shake, wrist_swing],
    each an axis-angle component."""
    N = rotmat.shape[0]
    res = torch.clamp(res, -0.25, 0.25)
    base = [torch.zeros(N, dtype=rotmat.dtype, device=rotmat.device) for _ in range(4)]
    in_fh_or_bh = torch.zeros(N, dtype=torch.bool, device=rotmat.device)
    for field, lo, hi, st, val in RESIDUAL_TABLES[spec.player]:
        m = (phase > lo) & (phase < hi) & (swing_type == st)
        base[field] = torch.where(m, val, base[field])
        if st in (1, 2):
            in_fh_or_bh = in_fh_or_bh | m
    if not spec.is_train:
        res = torch.where(in_fh_or_bh[:, None], res, 0.0)   # test-time gate

    elbow_j, wrist_j = spec.residual_joints
    pi = np.pi
    elbow_aa = R.rotmat_to_angle_axis(rotmat[:, elbow_j])
    elbow_aa = torch.cat([((base[0] + res[:, 0]) * pi)[:, None], elbow_aa[:, 1:]], dim=-1)
    wrist_aa = torch.stack([
        base[1] * pi,                      # wrist twist (no residual)
        (base[2] + res[:, 1]) * pi,        # wrist shake
        (base[3] + res[:, 2]) * pi,        # wrist swing
    ], dim=-1)
    rotmat = rotmat.clone()
    rotmat[:, elbow_j] = R.angle_axis_to_rotmat(elbow_aa)
    rotmat[:, wrist_j] = R.angle_axis_to_rotmat(wrist_aa)
    return rotmat


def make_random_spec(seed: int = 0, player: str = "federer", latent_size: int = 32,
                     hidden: int = 64, experts: int = 3, predict_phase: bool = True,
                     device=None) -> MVAEPlayerSpec:
    """Untrained MVAE spec at the given widths, initialized from a seeded
    CPU generator (the same weights on every device). hidden 256 and 6
    experts are the federer MVAE's full width; the defaults are test widths."""
    from ..mvae.model import PoseMixtureVAE

    dev = resolve_device(device)
    model = PoseMixtureVAE(
        frame_size_cond=FRAME_SIZE, frame_size_truth=FRAME_SIZE,
        frame_size_pred=FRAME_SIZE + (2 if predict_phase else 0),
        latent_size=latent_size, hidden_size=hidden, num_experts=experts,
        generator=torch.Generator().manual_seed(seed)).to(dev)
    model.requires_grad_(False)
    return MVAEPlayerSpec(
        decoder=model, avg=torch.zeros(FRAME_SIZE, device=dev),
        std=torch.ones(FRAME_SIZE, device=dev), player=player, latent_size=latent_size,
        predict_phase=predict_phase)


def spec_from_trainer(trainer, player: str = "federer", **kw) -> MVAEPlayerSpec:
    """A spec from an `MVAETrainer`, on the trainer's device: a frozen
    snapshot of its model (a copy without gradients, so training on does not
    move a spec that an env is stepping) with the dataset's normalization
    stats."""
    opt, dev = trainer.opt, trainer.device
    model = copy.deepcopy(trainer.model).requires_grad_(False)

    def stat(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return MVAEPlayerSpec(
        decoder=model, avg=stat(trainer.dataset.avg), std=stat(trainer.dataset.std),
        player=player, latent_size=opt.latent_size,
        num_condition_frames=opt.num_condition_frames, predict_phase=opt.predict_phase,
        num_future_predictions=opt.num_future_predictions, **kw)
