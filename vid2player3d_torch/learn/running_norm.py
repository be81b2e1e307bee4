"""Running mean/std normalizers as explicit state (PyTorch counterpart of
``learn/running_norm.py``):

    w = n/(n+m);  var ← w·var + (1−w)·var_x + w(1−w)(mean_x−mean)²
    y = clip((x − mean)/(std + 1e-8), ±clip)

Used for observation filtering and value normalization. Updates return new
state; nothing is modified in place. Under data parallelism (`mesh=`) the
batch is every rank's rows: its count, mean and variance are merged across
the ranks first (the variance from the squared deviations about the global
mean, two passes, not from the sum of squares), then merged as above.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RunningNormState:
    n: torch.Tensor      # scalar count
    mean: torch.Tensor   # (D,)
    var: torch.Tensor    # (D,)

    @classmethod
    def create(cls, dim: int, device="cpu"):
        return cls(n=torch.zeros((), device=device), mean=torch.zeros(dim, device=device),
                   var=torch.zeros(dim, device=device))


def update(state: RunningNormState, x: torch.Tensor, mesh=None) -> RunningNormState:
    """Merge a batch (..., D) into the running stats (batch Welford merge);
    with a data-parallel `mesh` the batch is the union of every rank's `x`."""
    x = x.reshape(-1, x.shape[-1])
    if mesh is not None and mesh.collective:
        from ..parallel import all_reduce_sum

        s = all_reduce_sum(torch.cat([x.sum(0), x.new_full((1,), x.shape[0])]), mesh)
        m, mean_x = s[-1], s[:-1] / s[-1]
        var_x = all_reduce_sum(((x - mean_x) ** 2).sum(0), mesh) / m
    else:
        m = x.shape[0]
        mean_x = torch.mean(x, dim=0)
        var_x = torch.var(x, dim=0, unbiased=False)
    w = state.n / (state.n + m)
    var = w * state.var + (1 - w) * var_x + w * (1 - w) * (mean_x - state.mean) ** 2
    mean = w * state.mean + (1 - w) * mean_x
    return RunningNormState(n=state.n + m, mean=mean, var=var)


def normalize(state: RunningNormState, x, clip: float = 5.0):
    y = (x - state.mean) / (torch.sqrt(state.var) + 1e-8)
    if clip:
        y = torch.clamp(y, -clip, clip)
    return torch.where(state.n > 0, y, x)


def unnormalize_value(state: RunningNormState, y):
    """Inverse transform for value heads."""
    return torch.where(state.n > 0, y * (torch.sqrt(state.var) + 1e-8) + state.mean, y)


def normalize_value(state: RunningNormState, x):
    return torch.where(state.n > 0, (x - state.mean) / (torch.sqrt(state.var) + 1e-8), x)
