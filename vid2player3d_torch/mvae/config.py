"""MotionVAE option registry with version inheritance (copy of
``vid2player3d_tpu/mvae/config.py``, which is plain Python): a dataclass of
options plus a dict registry whose entries inherit through `base_opt_ver`
chains.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class MVAEOption:
    # dataset selection (reference `config.py:4-15`, `dataset.py:52-99`)
    model_ver: str = "base"
    player_name: Optional[Sequence[str]] = None
    side: str = "fg"                       # fg | bg | both
    database_ratio: float = 1.0
    dataset_dir: Optional[str] = None      # manifest.json + mmapped npy dir
    background: Optional[Sequence[str]] = None    # None = any
    gender: Optional[Sequence[str]] = None        # None = any
    player_handness: Optional[Sequence[str]] = None

    # feature assembly (reference `dataset.py:188-212`)
    pose_feature: Tuple[str, ...] = (
        "root_pos", "root_velo", "joint_pos", "joint_velo", "joint_rotmat")
    condition_root_x_only: bool = False
    no_condition_root_y: bool = False
    predict_phase: bool = False
    num_joints: int = 24

    # network (reference `config.py:18-24`)
    frame_size: Optional[int] = None
    latent_size: int = 32
    hidden_size: int = 256
    num_condition_frames: int = 1
    num_future_predictions: int = 1
    num_experts: int = 6

    # training (reference `config.py:27-48`)
    nframes_seq: int = 10
    nseqs: int = 50000
    curriculum_schedule: Optional[Tuple[float, float]] = None
    mixed_phase_schedule: Optional[Tuple[Tuple[float, float],
                                         Tuple[float, float]]] = None
    weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"recon": 1.0, "kl": 1.0, "recon_phase": 10.0})
    softmax_future: bool = False
    batch_size: int = 64
    n_epochs: int = 500
    n_epochs_decay: int = 500
    save_freq_epoch: int = 100
    lr: float = 1e-4
    checkpoint_dir: str = "results/motionVAE"
    seed: int = 0

    def resolved_frame_size(self) -> int:
        """Per-frame feature width from the selected feature groups."""
        if self.frame_size is not None:
            return self.frame_size
        nj = self.num_joints
        size = 0
        for feat in self.pose_feature:
            if feat == "root_pos":
                size += 1 if self.condition_root_x_only else (
                    2 if self.no_condition_root_y else 3)
            elif feat == "root_velo":
                size += 3
            elif feat in ("joint_pos", "joint_velo"):
                size += (nj - 1) * 3
            elif feat == "joint_rotmat":
                size += nj * 6
            elif feat == "joint_quat":
                size += nj * 4
            else:
                raise ValueError(f"unknown pose feature {feat!r}")
        return size

    @classmethod
    def load(cls, version: str) -> "MVAEOption":
        """Resolve a registry entry through its `base_opt_ver` chain
        (reference `config.py:74-82`)."""
        stack = [MVAE_OPT_REGISTRY[version]]
        while "base_opt_ver" in stack[-1]:
            stack.append(MVAE_OPT_REGISTRY[stack[-1]["base_opt_ver"]])
        opt = cls()
        for entry in reversed(stack):
            for k, v in entry.items():
                if k != "base_opt_ver":
                    setattr(opt, k, v)
        return opt


# Mirrors `motion_vae_opt_dict` (reference `config.py:85-123`): federer is the
# base recipe; djokovic/nadal inherit and swap the player filter.
MVAE_OPT_REGISTRY: Dict[str, dict] = {
    "federer": {
        "model_ver": "federer",
        "player_name": ["Federer"],
        "side": "fg",
        "pose_feature": ("root_pos", "root_velo", "joint_rotmat",
                         "joint_pos", "joint_velo"),
        "predict_phase": True,
        "frame_size": 6 + 24 * 6 + 23 * 3 + 23 * 3,
        "num_condition_frames": 1,
        "num_future_predictions": 1,
        "nframes_seq": 10,
        "batch_size": 100,
        "nseqs": 50000,
        "softmax_future": True,
        "curriculum_schedule": (0.1, 0.2),
        "mixed_phase_schedule": ((0.0, 1.0), (0.5, 0.1)),
        "weights": {"recon": 1.0, "kl": 0.5, "recon_phase": 10.0},
        "n_epochs": 250,
        "n_epochs_decay": 250,
        "save_freq_epoch": 50,
    },
    "djokovic": {"model_ver": "djokovic", "base_opt_ver": "federer",
                 "player_name": ["Djokovic"]},
    "nadal": {"model_ver": "nadal", "base_opt_ver": "federer",
              "player_name": ["Nadal"]},
}
