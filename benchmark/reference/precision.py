"""The control's precision: the step below what a configuration states.

A trunk the configuration runs in bfloat16 runs here in fp8 (e4m3) instead:
its input and its weight are each scaled by their largest magnitude to fp8's
range, rounded to fp8 and scaled back, and the product is taken in float32.
The rounding passes the gradient straight through, so the control trains.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to fp8 under one scale for the whole tensor (value), with
    the identity as its gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(FP8).to(x.dtype) * scale
    return x + (q - x).detach()


def _fp8_trunk(self, layers, x):
    for layer in layers:
        x = F.relu(F.linear(fp8_round(x.float()), fp8_round(layer.weight), layer.bias))
    return x


def fp8_trunks(net) -> None:
    """Run an actor-critic's trunks in fp8 (see the module docstring)."""
    net._trunk = types.MethodType(_fp8_trunk, net)
