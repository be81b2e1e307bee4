"""MotionVAE random-walk rollout harness (counterpart of
``vid2player3d_tpu/mvae/eval.py``).

Drives a trained MVAE autoregressively with random latents through the
tennis player's decode/integrate step (``tennis/player.py``), K2 in every
decode, and measures whether the generated motion stays body-plausible:

- **bone-length drift**: mean skeleton bone length at the end of the
  rollout vs the start;
- **foot skate**: mean horizontal speed of the lower foot while it is near
  its own low point;
- **phase step**: mean per-frame phase advance and the fraction of frames
  with a small step;
- **root speed**: mean root displacement per frame;
- **wrist speed**: mean, p99 and max of the world wrist speed.

The rollout runs on the spec's device; its latents come from a generator
there, or are fed as `draws=` (standard normals, scaled by `latent_scale`).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from ..core.smpl import SMPL_BONE_ORDER_NAMES, SMPL_PARENTS
from ..parallel import mesh as PM
from ..tennis import player as P
from ..utils import graphs
from ..utils.runtime import as_draw


def random_walk_rollout(spec: "P.MVAEPlayerSpec", init_feature_raw,
                        num_steps: int = 300, seed: int = 0,
                        latent_scale: float = 1.0, draws=None):
    """Autoregressive rollout with z = latent_scale * N(0, 1) from raw init
    frames (N, F). `draws` (num_steps, N, latent) feeds the normals.
    Returns numpy (T, N, 3) root_pos, (T, N, 23, 3) joint_pos, (T, N)
    phase. On the card each step is one replay of a CUDA graph over
    `P.step`, the normals drawn outside it, as JAX scans the rollout; the
    graph is kept for the next walk of the same shape."""
    roll = _random_walk_graphed if spec.avg.device.type == "cuda" else _random_walk_eager
    return roll(spec, init_feature_raw, num_steps, seed, latent_scale, draws)


def _walk_start(spec, init_feature_raw, seed, draws):
    """(the reset state, the latents' generator or None, the fed normals or
    None)."""
    dev = spec.avg.device
    state = P.reset(spec, torch.as_tensor(np.asarray(init_feature_raw), dtype=torch.float32,
                                          device=dev))
    if draws is None:
        return state, torch.Generator(dev).manual_seed(seed), None
    return state, None, as_draw(draws, torch.float32, dev)


@torch.no_grad()
def _random_walk_eager(spec, init_feature_raw, num_steps, seed, latent_scale, draws):
    """`random_walk_rollout` op by op from the host: the oracle of the
    graphed one, and the path off the card."""
    state, gen, draws = _walk_start(spec, init_feature_raw, seed, draws)
    N, dev = state.root_pos.shape[0], spec.avg.device
    roots, joints, phases = [], [], []
    for t in range(num_steps):
        z = draws[t] if draws is not None else torch.randn(
            (N, spec.latent_size), generator=gen, device=dev)
        state = P.step(spec, state, latent_scale * z, None)
        roots.append(state.root_pos)
        joints.append(state.joint_pos_kin)
        phases.append(state.phase_pred)
    return (torch.stack(roots).cpu().numpy(), torch.stack(joints).cpu().numpy(),
            torch.stack(phases).cpu().numpy())


# the graphed walk's statics and graph, one set per device (`_walk_statics`)
_WALKS: Dict[str, SimpleNamespace] = {}


def _spec_leaves(spec) -> list:
    """The tensors a spec holds: its decoder's parameters and buffers and its
    normalization stats."""
    return list(spec.decoder.parameters()) + list(spec.decoder.buffers()) + [spec.avg, spec.std]


def _walk_statics(spec, state, num_steps: int, latent_scale: float) -> SimpleNamespace:
    """The graphed walk's static tensors and `StaticGraph` for this shape:
    a spec of its own (`spec`, refreshed from the caller's with `copy_`
    before each walk), the state, the latents, the row and the (T, N, ...)
    record buffers. Kept per device across calls and made anew when the
    shape (steps, the state's and the spec's shapes, its fields, the latent
    scale) changes, so a second report of the same shape replays the graph
    with no capture."""
    dev = spec.avg.device
    leaves = _spec_leaves(spec)
    fields = tuple(getattr(spec, f.name) for f in dataclasses.fields(spec)
                   if f.name not in ("decoder", "avg", "std"))
    key = (num_steps, float(latent_scale), fields, type(spec.decoder),
           tuple((tuple(t.shape), t.dtype) for t in leaves + PM.tree_leaves(state)))
    w = _WALKS.get(str(dev))
    if w is not None and w.key == key:
        return w
    _WALKS.pop(str(dev), None)                # the old graph's pool goes first
    w = SimpleNamespace(
        key=key, spec=dataclasses.replace(spec, decoder=copy.deepcopy(spec.decoder),
                                          avg=spec.avg.clone(), std=spec.std.clone()),
        state=PM.tree_map(torch.clone, state),
        z=torch.empty(state.root_pos.shape[0], spec.latent_size, device=dev),
        row=torch.zeros(1, dtype=torch.long, device=dev),
        out=tuple(torch.empty((num_steps,) + x.shape, dtype=x.dtype, device=dev)
                  for x in (state.root_pos, state.joint_pos_kin, state.phase_pred)))

    def body():
        with torch.no_grad():
            s = P.step(w.spec, w.state, latent_scale * w.z, None)
            for buf, x in zip(w.out, (s.root_pos, s.joint_pos_kin, s.phase_pred)):
                buf.index_copy_(0, w.row, x[None])
            w.row.add_(1)
            graphs.refresh(PM.tree_leaves(w.state), PM.tree_leaves(s))

    w.step = graphs.StaticGraph(body, dev)
    _WALKS[str(dev)] = w
    return w


@torch.no_grad()
def _random_walk_graphed(spec, init_feature_raw, num_steps, seed, latent_scale, draws):
    """`random_walk_rollout` with each step one replay of a `StaticGraph`
    over the static spec, state and latents, the rows written into static
    (T, N, ...) buffers; the normals drawn (or copied in) outside it. The
    statics and the graph outlive the call (`_walk_statics`): a spec is a
    frozen snapshot made anew for each report, so its leaves are copied
    into the statics' own spec."""
    state, gen, draws = _walk_start(spec, init_feature_raw, seed, draws)
    N, dev = state.root_pos.shape[0], spec.avg.device
    w = _walk_statics(spec, state, num_steps, latent_scale)
    graphs.refresh(_spec_leaves(w.spec) + PM.tree_leaves(w.state),
                   _spec_leaves(spec) + PM.tree_leaves(state))
    w.row.zero_()
    for t in range(num_steps):
        if draws is None:
            torch.randn((N, spec.latent_size), generator=gen, device=dev, out=w.z)
        else:
            w.z.copy_(draws[t])
        w.step()
    # copies: the next walk of this shape overwrites the buffers
    return tuple(x.to("cpu", copy=True).numpy() for x in w.out)


def _bone_lengths(root, joints):
    """Mean bone length per frame. joints (T,N,23,3) ROOT-RELATIVE joints
    1..23 in SMPL order (the dataset/feature convention, `dataset.py`
    assemble_features): pelvis sits at the origin of the relative frame."""
    full = np.concatenate([np.zeros_like(root)[:, :, None], joints], axis=2)
    lens = []
    for j in range(1, 24):
        p = int(SMPL_PARENTS[j])
        lens.append(np.linalg.norm(full[:, :, j] - full[:, :, p], axis=-1))
    return np.stack(lens, axis=-1).mean(-1)                    # (T,N)


def random_walk_metrics(spec: "P.MVAEPlayerSpec", init_feature_raw,
                        num_steps: int = 300, seed: int = 0, draws=None
                        ) -> Dict[str, float]:
    """The rollout's metrics (see the module docstring); `draws` as for
    `random_walk_rollout`."""
    root, joints, phase = random_walk_rollout(spec, init_feature_raw,
                                              num_steps, seed, draws=draws)
    T = root.shape[0]
    report: Dict[str, float] = {"finite": bool(np.isfinite(joints).all())}

    # bone-length drift: late-window mean vs early-window mean
    bl = _bone_lengths(root, joints)
    early, late = bl[: T // 5].mean(), bl[-T // 5:].mean()
    report["bone_len_mean"] = float(bl.mean())
    report["bone_len_drift"] = float(abs(late - early) / max(early, 1e-6))

    # foot skate: horizontal foot speed while the foot is within 5 cm of its
    # own per-env minimum height (stance proxy)
    la = SMPL_BONE_ORDER_NAMES.index("L_Ankle") - 1
    ra = SMPL_BONE_ORDER_NAMES.index("R_Ankle") - 1
    # world feet = root + root-relative joint (relative offsets are in world
    # axes) — skate must be measured in the world frame
    feet = root[:, :, None] + joints[:, :, (la, ra)]           # (T,N,2,3)
    vel = np.linalg.norm(np.diff(feet[..., :2], axis=0), axis=-1)  # (T-1,N,2)
    low = feet[1:, ..., 2] < (feet[..., 2].min(0, keepdims=True) + 0.05)[0]
    denom = max(low.sum(), 1)
    report["foot_skate"] = float((vel * low).sum() / denom * 30.0)  # m/s

    # phase channel: smooth forward advance through [0, 2pi)
    dph = np.diff(phase, axis=0)
    dph = (dph + np.pi) % (2 * np.pi) - np.pi
    report["phase_step_mean"] = float(dph.mean())
    report["phase_smooth_frac"] = float((np.abs(dph) < 1.0).mean())

    # root motion sanity
    report["root_speed"] = float(
        np.linalg.norm(np.diff(root[..., :2], axis=0), axis=-1).mean() * 30.0)

    # swing speed: whether the latent space decodes contact-speed swings (a
    # 10-15 m/s racket head needs ~8-11 m/s at the wrist); p99/max over
    # frames x envs of the world wrist speed
    rw = SMPL_BONE_ORDER_NAMES.index("R_Wrist") - 1
    wrist = root[:, :, None] + joints[:, :, (rw,)]             # (T,N,1,3)
    wspeed = np.linalg.norm(np.diff(wrist[..., 0, :], axis=0),
                            axis=-1) * 30.0                    # (T-1,N) m/s
    report["wrist_speed_mean"] = float(wspeed.mean())
    report["wrist_speed_p99"] = float(np.percentile(wspeed, 99))
    report["wrist_speed_max"] = float(wspeed.max())
    return report


def report_for_trainer(trainer, num_steps: int = 300, num_envs: int = 8,
                       seed: int = 0) -> Dict[str, float]:
    """Random-walk report for an `MVAETrainer` through `spec_from_trainer`.
    The init conditions are the checkpoint's own `init_frames.npy` where the
    trainer's checkpoint directory has one (a decoder trained on one
    dataset diverges from another's frames), else frames drawn from
    `trainer.dataset`."""
    spec = P.spec_from_trainer(trainer)
    init_path = os.path.join(trainer.checkpoint_dir(), "init_frames.npy")
    if os.path.exists(init_path):
        init_raw = np.load(init_path)[:num_envs]
    else:
        init_raw = trainer.dataset.raw_init_frames(num_envs)
    return random_walk_metrics(spec, init_raw, num_steps=num_steps, seed=seed)
