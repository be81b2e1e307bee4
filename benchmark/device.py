"""The few device calls the harness makes, which the CPU tests run too."""

from __future__ import annotations

import torch


def sync(device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    """The peak of device memory allocated (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0
