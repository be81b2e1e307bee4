"""MotionVAE trainer (PyTorch counterpart of ``vid2player3d_tpu/mvae/train.py``).

One batch is an autoregressive window of `nframes_seq` frames: for each of
its `L - S - T + 1` frames, one forward (encoder, reparameterization with
standard-normal draws, the decoder's three K2 layers), the loss, a backward
(through K2's backward) and one Adam step (`learn.optim.adam_apply`, the JAX
trainer's `optax.adam`). Scheduled sampling decides per batch whether the
next condition frame is the ground truth or the model's own detached
prediction ("regressive").

Losses per frame:
  kl    = -0.5 * min(sum(1 + logvar - mu^2 - e^logvar), 0) / numel
  recon = future-weighted MSE on features
  phase = future-weighted MSE on the (sin, cos) phase, times the phase
          weight (0 on batches drawn without phase labels)

The random streams follow the JAX trainer's: the dataset's numpy generator
(windows), a numpy `default_rng(seed + 1)` for the schedules (per batch:
`_sample_phase`, then the dataset's `sample_batch`, then `_regressive`), and
the reparameterization noise from a torch generator seeded `seed + 2` on the
trainer's device, or fed as `draws=`. The schedule choices are host values
drawn before each window; the losses accumulate on the device and are read
once per epoch. The parameters are updated in place.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..learn.optim import adam_apply, init_adam
from ..utils import checkpoint as CK
from ..utils.runtime import as_draw, resolve_device
from .config import MVAEOption
from .dataset import PoseSequenceDataset
from .model import PoseMixtureVAE

LOSS_NAMES = ("recon", "kl", "recon_phase")


class MVAETrainer:

    def __init__(self, opt: MVAEOption, dataset: PoseSequenceDataset,
                 dataset_no_phase: Optional[PoseSequenceDataset] = None, device=None):
        """The model is initialized on the CPU from a generator seeded
        `opt.seed`, then moved to `device` (the card unless given)."""
        self.device = resolve_device(device)
        self.opt = opt
        self.dataset = dataset
        self.dataset_no_phase = dataset_no_phase
        if dataset.avg is None:
            dataset.get_normalization_stats()
        if dataset_no_phase is not None:
            dataset_no_phase.set_normalization_stats(dataset.avg, dataset.std)

        F = dataset.frame_size
        self.frame_size = F
        self.model = PoseMixtureVAE(
            frame_size_cond=F, frame_size_truth=F,
            frame_size_pred=F + (2 if opt.predict_phase else 0),
            latent_size=opt.latent_size, hidden_size=opt.hidden_size,
            num_condition_frames=opt.num_condition_frames,
            num_future_predictions=opt.num_future_predictions,
            num_experts=opt.num_experts,
            generator=torch.Generator().manual_seed(opt.seed)).to(self.device)
        self.params = list(self.model.parameters())
        self.opt_state = init_adam(self.params)
        self._np_rng = np.random.default_rng(opt.seed + 1)
        self.generator = torch.Generator(self.device).manual_seed(opt.seed + 2)

        S = opt.num_future_predictions
        if opt.softmax_future:
            fw = torch.softmax(torch.linspace(1, 0, S), dim=0)
        else:
            fw = torch.full((S,), 1.0 / S)
        self.future_weights = fw.to(self.device)
        self.epoch = 0

    # -- one window ---------------------------------------------------------

    def loss(self, cond, gt_feat, gt_phase, eps, phase_w: float):
        """One frame's forward and loss. cond (B, T, F), gt_feat (B, S, F),
        gt_phase (B, S, 2) normalized; eps (B, latent) standard normals.
        Returns (total, stacked (recon, kl, recon_phase), the first
        predicted frame (B, F))."""
        opt, w = self.opt, self.opt.weights
        B, S, F = gt_feat.shape
        out, mu, logvar = self.model(gt_feat.reshape(B, S * F), cond.reshape(B, -1), eps)
        if opt.predict_phase:
            out = out.reshape(B, S, F + 2)
            out_phase, out_feat = out[..., -2:], out[..., :-2]
        else:
            out_feat = out.reshape(B, S, F)
            out_phase = out.new_zeros((B, S, 2))
        # the inner sum is clamped before the -0.5 factor
        inner = torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
        kl = -0.5 * torch.clamp(inner, max=0.0) / logvar.numel()
        recon = torch.sum(torch.mean((out_feat - gt_feat) ** 2, dim=(0, 2)) * self.future_weights)
        ph = torch.sum(torch.mean((out_phase - gt_phase) ** 2, dim=(0, 2)) * self.future_weights)
        losses = torch.stack([recon * w["recon"], kl * w["kl"], ph * phase_w])
        return losses[0] + losses[1] + losses[2], losses, out_feat[:, 0]

    def _train_window(self, feat, phase, regressive: bool, phase_w: float, lr, eps=None):
        """feat (B, L, F) normalized, phase (B, L, 2), on the device; eps
        (nsteps, B, latent) or None. Returns the losses' mean over the
        window's steps (3,), on the device."""
        B, L, F = feat.shape
        T, S = self.opt.num_condition_frames, self.opt.num_future_predictions
        nsteps = L - S - T + 1
        cond = feat[:, :T]
        prev = None
        acc = torch.zeros(3, device=self.device)
        for j in range(nsteps):
            i = T - 1 + j
            if j > 0:
                last = prev if regressive else feat[:, i]
                cond = torch.cat([cond[:, 1:], last[:, None]], dim=1)
            e = eps[j] if eps is not None else torch.randn(
                (B, self.opt.latent_size), generator=self.generator, device=self.device)
            total, losses, pred0 = self.loss(cond, feat[:, i + 1:i + 1 + S],
                                             phase[:, i + 1:i + 1 + S], e, phase_w)
            grads = torch.autograd.grad(total, self.params)
            self.opt_state = adam_apply(self.params, self.opt_state, grads, lr)
            prev = pred0.detach()
            acc += losses.detach()
        return acc / nsteps

    # -- host-side schedules ------------------------------------------------

    def _ramp(self, lo_frac: float, hi_frac: float, epoch: int) -> float:
        total = self.opt.n_epochs + self.opt.n_epochs_decay
        lo, hi = int(total * lo_frac), int(total * hi_frac)
        return min(hi - lo, max(0, epoch - lo)) / max(hi - lo, 1)

    def _regressive(self, epoch: int) -> bool:
        sched = self.opt.curriculum_schedule
        if sched is None:
            return True
        return bool(self._np_rng.random() <= self._ramp(sched[0], sched[1], epoch))

    def _sample_phase(self, epoch: int) -> bool:
        sched = self.opt.mixed_phase_schedule
        if sched is None:
            return True
        (e1, t1), (e2, t2) = sched
        p = self._ramp(e1, e2, epoch)
        return bool(self._np_rng.random() <= t1 + (t2 - t1) * p)

    def current_lr(self) -> float:
        decay = max(0, self.epoch - self.opt.n_epochs)
        return self.opt.lr * max(0.0, 1.0 - decay / self.opt.n_epochs_decay)

    def train_epoch(self, batches_per_epoch: Optional[int] = None,
                    draws: Optional[Dict] = None) -> Dict[str, float]:
        """One epoch of `batches_per_epoch` windows (nseqs // batch_size
        unless given) at this epoch's lr. `draws={"eps": (batches, nsteps,
        B, latent)}` feeds the reparameterization noise. Returns the mean
        losses over the epoch (read from the device once)."""
        opt = self.opt
        nb = batches_per_epoch or max(1, opt.nseqs // opt.batch_size)
        lr = torch.tensor(self.current_lr(), dtype=torch.float32, device=self.device)
        eps = None if draws is None else as_draw(draws["eps"], torch.float32, self.device)
        acc = torch.zeros(3, device=self.device)
        for b in range(nb):
            use_phase = self._sample_phase(self.epoch)
            ds = self.dataset if (use_phase or self.dataset_no_phase is None) \
                else self.dataset_no_phase
            feat, phase = ds.sample_batch(opt.batch_size)
            regressive = self._regressive(self.epoch)
            phase_w = opt.weights.get("recon_phase", 0.0) if (
                opt.predict_phase and use_phase) else 0.0
            acc += self._train_window(
                torch.as_tensor(feat, dtype=torch.float32, device=self.device),
                torch.as_tensor(phase, dtype=torch.float32, device=self.device),
                regressive, phase_w, lr, None if eps is None else eps[b])
        self.epoch += 1
        return dict(zip(LOSS_NAMES, (acc / nb).tolist()))

    # -- inference + IO -------------------------------------------------------

    @torch.no_grad()
    def decode(self, z, cond):
        """Batched decode of a latent given the flattened condition; returns
        (next frame's normalized features, phase (sin, cos))."""
        return self.model.first_frame(z, cond, self.opt.num_future_predictions,
                                      self.opt.predict_phase)

    def checkpoint_dir(self) -> str:
        return os.path.join(self.opt.checkpoint_dir, self.opt.model_ver)

    def save_checkpoint(self, label: str = "latest") -> None:
        """`<label>.npz` (the params under the JAX trainer's flax keys),
        `avg.npy`, `std.npy`, and `init_frames.npy`: 256 raw dataset frames,
        drawn from the dataset's generator, as init conditions for rollouts
        and tennis resets."""
        d = self.checkpoint_dir()
        CK.save_npz(os.path.join(d, f"{label}.npz"),
                    CK.mvae_params_to_jax(self.model.state_dict()))
        np.save(os.path.join(d, "avg.npy"), self.dataset.avg)
        np.save(os.path.join(d, "std.npy"), self.dataset.std)
        np.save(os.path.join(d, "init_frames.npy"), self.dataset.raw_init_frames(256))

    def load_checkpoint(self, label: str = "latest") -> None:
        """Params (copied into the model in place; every key must be in the
        file) and the normalization stats of a checkpoint directory that
        this trainer or the JAX trainer wrote."""
        d = self.checkpoint_dir()
        path = os.path.join(d, f"{label}.npz")
        flat = CK.load_npz(path)
        missing = [k for k in CK.mvae_params_to_jax(self.model.state_dict()) if k not in flat]
        if missing:
            raise KeyError(f"checkpoint {path} missing keys: {missing[:5]}")
        with torch.no_grad():
            self.model.load_state_dict(CK.mvae_params_from_jax(flat))
        self.dataset.set_normalization_stats(np.load(os.path.join(d, "avg.npy")),
                                             np.load(os.path.join(d, "std.npy")))
