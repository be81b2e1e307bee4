"""Device resolution shared by the port's entry points, and the conversion
of fed random draws."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the card.

    There is no silent fallback: with no `device` and no CUDA device this
    raises, so a run meant for the card never lands on the CPU unnoticed.
    Tests and CPU runs pass device="cpu" explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_draw(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A random draw handed in by the caller (numpy array or tensor) as a
    tensor of `dtype` on `device`; numpy input is copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)
