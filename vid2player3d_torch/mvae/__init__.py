"""Mixture-of-experts motion VAE: its option registry, the network, the
pose dataset and the trainer."""

from .config import MVAE_OPT_REGISTRY, MVAEOption
from .dataset import (PoseSequenceDataset, load_video_dataset, make_synthetic_pose_dataset,
                      phase_from_hits, write_video_dataset)
from .model import PoseMixtureVAE
from .train import MVAETrainer

__all__ = [
    "MVAEOption", "MVAE_OPT_REGISTRY", "PoseMixtureVAE",
    "PoseSequenceDataset", "phase_from_hits", "make_synthetic_pose_dataset",
    "load_video_dataset", "write_video_dataset",
    "MVAETrainer",
]
