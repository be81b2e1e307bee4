"""Conditional mixture-of-experts motion VAE (PyTorch counterpart of
``vid2player3d_tpu/mvae/model.py``).

- `Encoder`: skip-concat MLP; the truth frame is concatenated in front of
  every hidden layer.
- `MoEDecoder`: a gating MLP gives softmax expert coefficients; each of its
  three layers is a blended-expert linear layer, K2 (`ops.moe_linear`).
- `PoseMixtureVAE` ties them together; `sample` is the controller's path
  (decode a latent given the condition frames).

Everything is float32. Latent 32, hidden 256, 6 experts by default. The
initializers follow the flax modules' (lecun-normal Dense kernels, zero
biases, he-uniform expert weights, expert biases 0.01); weights trained by
the JAX package load through `utils.checkpoint.mvae_params_from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..learn.networks import _variance_scaling_
from ..ops.moe_linear import moe_linear


def _dense(d_in: int, d_out: int, generator) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    _variance_scaling_(layer.weight, 1.0, generator)
    nn.init.zeros_(layer.bias)
    return layer


class Encoder(nn.Module):
    def __init__(self, x_size: int, c_size: int, latent_size: int, hidden_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = _dense(x_size + c_size, hidden_size, generator)
        self.fc2 = _dense(x_size + hidden_size, hidden_size, generator)
        self.mu = _dense(x_size + hidden_size, latent_size, generator)
        self.logvar = _dense(x_size + hidden_size, latent_size, generator)

    def forward(self, x, c) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: flattened future truth (B, S*F_truth); c: flattened condition
        (B, T*F_cond). Returns (mu, logvar)."""
        h1 = F.elu(self.fc1(torch.cat([x, c], dim=-1)))
        h2 = F.elu(self.fc2(torch.cat([x, h1], dim=-1)))
        s = torch.cat([x, h2], dim=-1)
        return self.mu(s), self.logvar(s)


class MoELayer(nn.Module):
    """One blended-expert linear layer: w (E, in, out), b (E, out)."""

    def __init__(self, num_experts: int, in_size: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # he_uniform over flax's fans for an (E, in, out) kernel: fan_in = E*in
        lim = math.sqrt(6.0 / (num_experts * in_size))
        w = torch.rand(num_experts, in_size, out_size, generator=generator) * (2 * lim) - lim
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.full((num_experts, out_size), 0.01))

    def forward(self, coeff, h):
        return moe_linear(h.contiguous(), coeff.contiguous(), self.w, self.b)


class MoEDecoder(nn.Module):
    def __init__(self, frame_size_cond: int, frame_size_out: int, latent_size: int,
                 hidden_size: int, num_condition_frames: int, num_future_predictions: int,
                 num_experts: int, gate_hsize: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        input_size = latent_size + frame_size_cond * num_condition_frames
        inter_size = latent_size + hidden_size
        output_size = num_future_predictions * frame_size_out
        self.gate1 = _dense(input_size, gate_hsize, generator)
        self.gate2 = _dense(gate_hsize, gate_hsize, generator)
        self.gate3 = _dense(gate_hsize, num_experts, generator)
        self.moe0 = MoELayer(num_experts, input_size, hidden_size, generator)
        self.moe1 = MoELayer(num_experts, inter_size, hidden_size, generator)
        self.moe2 = MoELayer(num_experts, inter_size, output_size, generator)

    def forward(self, z, c):
        zc = torch.cat([z, c], dim=-1)
        g = F.elu(self.gate1(zc))
        g = F.elu(self.gate2(g))
        coeff = torch.softmax(self.gate3(g), dim=-1)
        h = F.elu(self.moe0(coeff, zc))
        h = F.elu(self.moe1(coeff, torch.cat([z, h], dim=-1)))
        return self.moe2(coeff, torch.cat([z, h], dim=-1))


class PoseMixtureVAE(nn.Module):
    """Conditional MoE VAE over per-frame motion features. `frame_size_pred`
    may exceed `frame_size_cond` when phase (sin, cos) is appended to the
    prediction."""

    def __init__(self, frame_size_cond: int, frame_size_truth: int, frame_size_pred: int,
                 latent_size: int = 32, hidden_size: int = 256, num_condition_frames: int = 1,
                 num_future_predictions: int = 1, num_experts: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latent_size = latent_size
        self.encoder = Encoder(frame_size_truth * num_future_predictions,
                               frame_size_cond * num_condition_frames, latent_size,
                               hidden_size, generator)
        self.decoder = MoEDecoder(frame_size_cond, frame_size_pred, latent_size, hidden_size,
                                  num_condition_frames, num_future_predictions, num_experts,
                                  generator=generator)

    def forward(self, x, c, eps):
        """Train forward: encode truth+condition, reparameterize with the
        standard-normal draws `eps`, decode."""
        mu, logvar = self.encoder(x, c)
        z = mu + eps * torch.exp(0.5 * logvar)
        return self.decoder(z, c), mu, logvar

    def encode(self, x, c):
        return self.encoder(x, c)

    def sample(self, z, c):
        """Controller inference path: decode a latent given the condition."""
        return self.decoder(z, c)

    def first_frame(self, z, c, num_future_predictions: int, predict_phase: bool):
        """(normalized features (N, F), phase sin/cos (N, 2)) of the first of
        the `num_future_predictions` decoded frames (`first_frame`)."""
        return first_frame(self.sample(z, c), num_future_predictions, predict_phase)


def first_frame(out, num_future_predictions: int, predict_phase: bool):
    """The first of the decoder output's `num_future_predictions` frames as
    (normalized features (N, F), phase sin/cos (N, 2)); the phase pair is
    each frame's last two outputs when predicted, else zeros."""
    out = out.reshape(out.shape[0], num_future_predictions, -1)[:, 0]
    if predict_phase:
        return out[:, :-2], out[:, -2:]
    return out, out.new_zeros((out.shape[0], 2))
