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

On the card every window is replayed from one CUDA graph over static
tensors (``utils/graphs.py``; JAX's `_train_fused` runs `fuse` windows as
one program): `train_epoch(fuse=k)` copies k windows' host draws to the
device at once and replays the graph per window, with each window's normals
drawn outside it in the eager order. On the CPU the windows run eagerly.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..learn.optim import AdamState, adam_apply, init_adam
from ..utils import checkpoint as CK
from ..utils import graphs
from ..utils.runtime import as_draw, resolve_device
from .config import MVAEOption
from .dataset import PoseSequenceDataset
from .model import PoseMixtureVAE, first_frame

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
        # the graphed window's static tensors and graph, made at its first call
        self._graph = None

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

    def _window(self, feat, phase, regressive, phase_w, lr, eps=None, count=None):
        """One window of `nsteps` optimizer steps (JAX's `_train_window_body`).
        feat (B, L, F) normalized, phase (B, L, 2), on the device; eps
        (nsteps, B, latent) or None (drawn from `generator`); `regressive` a
        0-d bool tensor (each condition frame is selected with `torch.where`,
        which is exact); `phase_w` a float or a 0-d tensor.
        With `count` (a static int32 0-d tensor) the Adam step count is read
        from it and the window's last written back to it. Returns the losses' mean over the
        window's steps (3,), on the device."""
        B, L, F = feat.shape
        T, S = self.opt.num_condition_frames, self.opt.num_future_predictions
        nsteps = L - S - T + 1
        cond = feat[:, :T]
        prev = None
        state = self.opt_state if count is None else AdamState(count, self.opt_state.mu,
                                                               self.opt_state.nu)
        acc = torch.zeros(3, device=self.device)
        for j in range(nsteps):
            i = T - 1 + j
            if j > 0:
                last = torch.where(regressive, prev, feat[:, i])
                cond = torch.cat([cond[:, 1:], last[:, None]], dim=1)
            e = eps[j] if eps is not None else torch.randn(
                (B, self.opt.latent_size), generator=self.generator, device=self.device)
            total, losses, pred0 = self.loss(cond, feat[:, i + 1:i + 1 + S],
                                             phase[:, i + 1:i + 1 + S], e, phase_w)
            grads = torch.autograd.grad(total, self.params)
            state = adam_apply(self.params, state, grads, lr)
            prev = pred0.detach()
            acc += losses.detach()
        if count is None:
            self.opt_state = state
        else:
            count.copy_(state.count)
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

    def _batch(self):
        """The next window's host draws, in the JAX trainer's order: (feat,
        phase, regressive, phase weight)."""
        opt = self.opt
        use_phase = self._sample_phase(self.epoch)
        ds = self.dataset if (use_phase or self.dataset_no_phase is None) \
            else self.dataset_no_phase
        feat, phase = ds.sample_batch(opt.batch_size)
        regressive = self._regressive(self.epoch)
        phase_w = opt.weights.get("recon_phase", 0.0) if (opt.predict_phase and use_phase) \
            else 0.0
        return feat, phase, regressive, phase_w

    def train_epoch(self, batches_per_epoch: Optional[int] = None, fuse: int = 16,
                    draws: Optional[Dict] = None) -> Dict[str, float]:
        """One epoch of `batches_per_epoch` windows (nseqs // batch_size
        unless given) at this epoch's lr. On the card the windows run in
        groups of `fuse` (JAX's `_train_fused`): one host-to-device copy of
        the group's host batches, then one CUDA-graph replay per window;
        on the CPU they run op by op and `fuse` changes nothing. The
        numbers do not depend on `fuse`. `draws={"eps": (batches, nsteps, B,
        latent)}` feeds the reparameterization noise. Returns the mean losses
        over the epoch (read from the device once)."""
        if fuse < 1:
            raise ValueError(f"fuse must be at least 1, got {fuse}")
        nb = batches_per_epoch or max(1, self.opt.nseqs // self.opt.batch_size)
        if self.device.type == "cuda":
            return self._train_epoch_graphed(nb, fuse, draws)
        return self._train_epoch_eager(nb, draws)

    def _finish_epoch(self, rows: torch.Tensor) -> Dict[str, float]:
        self.epoch += 1
        return dict(zip(LOSS_NAMES, rows.mean(0).tolist()))

    def _train_epoch_eager(self, nb: int, draws: Optional[Dict] = None) -> Dict[str, float]:
        """`train_epoch` op by op from the host: the CPU path and the oracle
        of the graphed one."""
        lr = torch.tensor(self.current_lr(), dtype=torch.float32, device=self.device)
        eps = None if draws is None else as_draw(draws["eps"], torch.float32, self.device)
        rows = []
        for b in range(nb):
            feat, phase, regressive, phase_w = self._batch()
            rows.append(self._window(
                torch.as_tensor(feat, dtype=torch.float32, device=self.device),
                torch.as_tensor(phase, dtype=torch.float32, device=self.device),
                torch.tensor(regressive, device=self.device), phase_w, lr,
                None if eps is None else eps[b]))
        return self._finish_epoch(torch.stack(rows))

    def _train_epoch_graphed(self, nb: int, fuse: int,
                             draws: Optional[Dict] = None) -> Dict[str, float]:
        """`train_epoch` with each window one call of a `StaticGraph`
        (replayed from a CUDA graph on the card; on the CPU the staged
        windows run as they are). Per group of `fuse` windows: the host
        draws, one copy of the group's inputs to the device, then per window
        its slice into the static input, its `eps` (drawn from `generator`
        in the eager order, or copied from `draws`) and the replay."""
        g = self._graph_statics()
        B, nsteps, latent = self.opt.batch_size, g.eps.shape[0], self.opt.latent_size
        g.lr.fill_(self.current_lr())
        g.count.copy_(self.opt_state.count)
        key = graphs.tensor_key(self.params + self.opt_state.mu + self.opt_state.nu)
        eps = None if draws is None else as_draw(draws["eps"], torch.float32, self.device)
        rows = torch.empty(nb, 3, device=self.device)
        done = 0
        while done < nb:
            k = min(fuse, nb - done)
            host = np.stack([np.concatenate([np.asarray(x, np.float32).reshape(-1)
                                             for x in self._batch()]) for _ in range(k)])
            group = torch.from_numpy(host).to(self.device)
            for j in range(k):
                g.inputs.copy_(group[j])
                if eps is None:
                    for s in range(nsteps):
                        torch.randn((B, latent), generator=self.generator, device=self.device,
                                    out=g.eps[s])
                else:
                    g.eps.copy_(eps[done + j])
                g.window(key)
                rows[done + j] = g.losses
            done += k
        self.opt_state = AdamState(g.count.clone(), self.opt_state.mu, self.opt_state.nu)
        return self._finish_epoch(rows)

    def _graph_statics(self) -> SimpleNamespace:
        """The graphed window's static tensors, made at the first call: one
        flat input [feat | phase | regressive | phase weight] (what a
        window's host draws concatenate to), the noise, lr, the Adam count,
        the losses; and its `StaticGraph`."""
        if self._graph is not None:
            return self._graph
        opt, dev = self.opt, self.device
        B, L, F = opt.batch_size, opt.nframes_seq, self.frame_size
        nsteps = L - opt.num_future_predictions - opt.num_condition_frames + 1
        inputs = torch.zeros(B * L * F + B * L * 2 + 2, device=dev)
        g = SimpleNamespace(
            inputs=inputs, feat=inputs[:B * L * F].view(B, L, F),
            phase=inputs[B * L * F:B * L * (F + 2)].view(B, L, 2),
            regressive=inputs[-2], phase_w=inputs[-1],
            eps=torch.zeros(nsteps, B, opt.latent_size, device=dev),
            lr=torch.zeros((), device=dev), count=torch.zeros((), dtype=torch.int32, device=dev),
            losses=torch.zeros(3, device=dev))

        def body():
            g.losses.copy_(self._window(g.feat, g.phase, g.regressive > 0.5, g.phase_w, g.lr,
                                        g.eps, g.count))

        g.window = graphs.StaticGraph(body, dev)
        self._graph = g
        return g

    # -- inference + IO -------------------------------------------------------

    @torch.no_grad()
    def decode(self, params, z, cond):
        """Batched decode of a latent given the flattened condition under
        `params` (the JAX trainer's argument order): the trainer's `params`
        list (the model's parameters in order) or a dict by parameter name,
        either the trainer's own or another set of the same shapes. Returns
        (next frame's normalized features, phase (sin, cos))."""
        names = [k for k, _ in self.model.named_parameters()]
        named = dict(params) if isinstance(params, dict) else dict(zip(names, params))
        if sorted(named) != sorted(names):
            raise ValueError(f"params {sorted(set(named) ^ set(names))[:4]} do not match the "
                             "model's")
        dec = {k[len("decoder."):]: v for k, v in named.items() if k.startswith("decoder.")}
        out = functional_call(self.model.decoder, dec, (z, cond))
        return first_frame(out, self.opt.num_future_predictions, self.opt.predict_phase)

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
