"""Pose-sequence dataset for MotionVAE training (counterpart of
``vid2player3d_tpu/mvae/dataset.py``, numpy throughout; the two rotation
conversions go through the port's ``core/rot.py`` in float32, as the JAX
package's run in float32).

The dataset ingests in-memory sequences and assembles the full per-frame
feature matrix once on the host; window sampling is a gather whose windows
the trainer moves to its device.

Feature layout per frame, in a fixed order whatever the option's tuple
order: root_pos (3, or 2/1 under the root-x/no-y options) | root_velo (3) |
joint_pos ((J-1)*3) | joint_velo ((J-1)*3) | joint_rot6d (J*6). Velocities
are one-frame backward differences, so a window of `nframes_seq` features
needs `nframes_seq + 1` valid pose frames.

Phase labels: for a frame between consecutive racket hits,
`phase = (t - prev_hit) / (next_hit - prev_hit)`, plus 1 while in recovery
(previous hit was by this player); stored as (sin, cos) of phase*pi.

The sampling generator is numpy's `default_rng(seed)`, drawn in the JAX
package's order, so one seed gives the same windows in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import rot as R
from .config import MVAEOption


def phase_from_hits(num_frames: int, hits: Sequence[Tuple[int, bool]]):
    """hits: sorted (frame_id, is_this_player) racket-contact annotations.
    Returns (phase_sincos (T,2), phase_rad (T,), valid (T,)) — frames outside
    [first_hit, last_hit] are marked invalid."""
    t = np.arange(num_frames)
    sincos = np.zeros((num_frames, 2), np.float32)
    rad = np.zeros(num_frames, np.float32)
    valid = np.zeros(num_frames, bool)
    for (f0, fg0), (f1, _) in zip(hits[:-1], hits[1:]):
        if f1 <= f0:
            continue
        sel = (t >= f0) & (t < f1)
        phase = (t[sel] - f0) / (f1 - f0) + (1.0 if fg0 else 0.0)
        rad[sel] = phase * np.pi
        sincos[sel, 0] = np.sin(phase * np.pi)
        sincos[sel, 1] = np.cos(phase * np.pi)
        valid[sel] = True
    return sincos, rad, valid


def assemble_features(opt: MVAEOption, joint_pos: np.ndarray,
                      joint_rotmat: np.ndarray) -> np.ndarray:
    """joint_pos (T,J,3) world positions with root at index 0; joint_rotmat
    (T,J,3,3). Returns (T,F) features; row t uses the t-1→t difference for
    velocities, so row 0 is only valid if a predecessor frame exists."""
    T = joint_pos.shape[0]
    root = joint_pos[:, 0]
    rest = joint_pos[:, 1:].reshape(T, -1)
    parts = []
    # the canonical feature order, not the option tuple's: the player's
    # unpack slices (`tennis/player.py`) depend on this exact layout
    order = ("root_pos", "root_velo", "joint_pos", "joint_velo",
             "joint_rotmat")
    if not set(opt.pose_feature) <= set(order):
        raise ValueError(f"unsupported pose features {opt.pose_feature}")
    for feat in (f for f in order if f in opt.pose_feature):
        if feat == "root_pos":
            if opt.condition_root_x_only:
                parts.append(root[:, 0:1])
            elif opt.no_condition_root_y:
                parts.append(root[:, [0, 2]])
            else:
                parts.append(root)
        elif feat == "root_velo":
            v = np.zeros_like(root)
            v[1:] = root[1:] - root[:-1]
            parts.append(v)
        elif feat == "joint_pos":
            parts.append(rest)
        elif feat == "joint_velo":
            v = np.zeros_like(rest)
            v[1:] = rest[1:] - rest[:-1]
            parts.append(v)
        elif feat == "joint_rotmat":
            r6 = R.rotmat_to_rot6d(torch.tensor(np.asarray(joint_rotmat),
                                                dtype=torch.float32)).numpy()
            parts.append(r6.reshape(T, -1))
        else:
            raise ValueError(f"unsupported pose feature {feat!r}")
    return np.concatenate(parts, axis=1).astype(np.float32)


class PoseSequenceDataset:
    """Rollout-window sampler over concatenated motion sequences."""

    def __init__(self, opt: MVAEOption, sequences: Sequence[Dict],
                 seed: int = 0):
        self.opt = opt
        feats, phases, valids = [], [], []
        self.seq_bounds: List[Tuple[int, int]] = []
        base = 0
        for seq in sequences:
            jp = np.asarray(seq["joint_pos"], np.float32)
            f = assemble_features(opt, jp, np.asarray(seq["joint_rotmat"]))
            T = f.shape[0]
            v = np.asarray(seq.get("valid", np.ones(T, bool)), bool).copy()
            v[0] = False  # row 0 has no backward difference
            ph = np.zeros((T, 2), np.float32)
            if opt.predict_phase:
                if "phase" in seq:
                    ph = np.asarray(seq["phase"], np.float32)
                elif "hits" in seq:
                    ph, _, pv = phase_from_hits(T, seq["hits"])
                    v &= pv
                else:
                    v[:] = False  # phase-labeled training skips unlabeled seqs
            feats.append(f)
            phases.append(ph)
            valids.append(v)
            self.seq_bounds.append((base, base + T))
            base += T
        self.feature_arr = np.concatenate(feats, axis=0)
        self.phase_arr = np.concatenate(phases, axis=0)
        self.valid_arr = np.concatenate(valids, axis=0)
        self.frame_size = self.feature_arr.shape[1]
        self._rng = np.random.default_rng(seed)
        self.init_rollouts(opt.nframes_seq)
        self.avg: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def init_rollouts(self, nframes_seq: int):
        """Window starts where nframes_seq+1 consecutive frames are valid
        (reference `dataset.py:112-122`); the window rows are start..start+L-1
        in feature space (velocities make row `start` depend on start-1)."""
        self.nframes_seq = L = nframes_seq
        ok = self.valid_arr.astype(np.int32)
        # need frames start-1 .. start+L-1 valid in pose space == feature rows
        # start..start+L-1 valid (row validity already folds in the t-1 frame)
        win = np.lib.stride_tricks.sliding_window_view(ok, L)
        starts = np.nonzero(win.sum(axis=1) == L)[0]
        # windows must not straddle sequence boundaries
        keep = np.zeros_like(starts, bool)
        for lo, hi in self.seq_bounds:
            keep |= (starts >= lo) & (starts + L <= hi)
        self.rollouts = starts[keep]
        if len(self.rollouts) == 0:
            raise ValueError("no valid rollout windows")

    def get_normalization_stats(self):
        rows = self.feature_arr[self.valid_arr]
        self.avg = rows.mean(axis=0)
        self.std = np.maximum(rows.std(axis=0), 1e-4).astype(np.float32)
        return self.avg, self.std

    def set_normalization_stats(self, avg, std):
        self.avg, self.std = np.asarray(avg), np.asarray(std)

    def sample_batch(self, batch_size: int):
        """Uniform-with-replacement window sampling (reference
        `dataset.py:180-183`). Returns feature (B,L,F) z-scored, phase
        (B,L,2)."""
        L = self.nframes_seq
        starts = self._rng.choice(self.rollouts, size=batch_size)
        idx = starts[:, None] + np.arange(L)[None, :]
        feat = self.feature_arr[idx]
        if self.avg is not None:
            feat = (feat - self.avg) / self.std
        return feat, self.phase_arr[idx]

    def raw_init_frames(self, n: int) -> "np.ndarray":
        """n RAW (unnormalized) dataset frames — init conditions for
        autoregressive rollouts / tennis-env resets (the reference loads
        init conditions from the dataset, `mvae_player.py:112-158`)."""
        feat, _ = self.sample_batch(n)
        raw = np.asarray(feat)[:, 0]
        if self.avg is not None:
            raw = raw * self.std + self.avg
        return raw.astype(np.float32)

    def sample_first_frame(self):
        """One normalized condition window + its raw start frame index, for
        seeding autoregressive rollouts (reference `dataset.py:225-236`)."""
        T = self.opt.num_condition_frames
        start = int(self._rng.choice(self.rollouts))
        cond = self.feature_arr[start:start + T]
        if self.avg is not None:
            cond = (cond - self.avg) / self.std
        return cond, start


def load_video_dataset(opt: MVAEOption, dataset_dir: Optional[str] = None
                       ) -> PoseSequenceDataset:
    """Manifest + mmapped-npy reader for video-reconstructed motion
    (reference `Video3DPoseDataset.__init__`, `dataset.py:13-110`).

    Directory layout (the reference's withheld dataset format):
      manifest.json   — list of videos:
        {name, background, gender, is_orig,
         sequences: {fg: [seq...], bg: [seq...]},
         points_annotation: [{keyframes: [{fid, fg}...]}...]}
        seq = {base, start, length, player, handness, beta, point_idx}
      joint_pos.npy    (total, J, 3)    float    — mmapped
      joint_rotmat.npy (total, J, 3, 3) float    — mmapped
      valid.npy        (total,)         bool

    Filtering mirrors the reference: video background/gender allowlists,
    side fg|bg|both, per-sequence player-name or handness selection; phase
    labels computed from hit keyframes when `opt.predict_phase`. The rows
    selected from the mmaps are materialized per sequence and handed to
    `PoseSequenceDataset` (window sampling, z-score stats, feature
    assembly)."""
    import json
    import os

    dataset_dir = dataset_dir or opt.dataset_dir
    with open(os.path.join(dataset_dir, "manifest.json")) as f:
        manifest = json.load(f)
    joint_pos = np.load(os.path.join(dataset_dir, "joint_pos.npy"),
                        mmap_mode="r")
    joint_rotmat = np.load(os.path.join(dataset_dir, "joint_rotmat.npy"),
                           mmap_mode="r")
    valid = np.load(os.path.join(dataset_dir, "valid.npy"))

    sequences: List[Dict] = []
    for video in manifest:
        if opt.background is not None and \
                video.get("background") not in opt.background:
            continue
        if opt.gender is not None and video.get("gender") not in opt.gender:
            continue
        if opt.side == "both":
            cands = video["sequences"].get("fg", []) \
                + video["sequences"].get("bg", [])
        else:
            cands = video["sequences"].get(opt.side, [])
        for seq in cands:
            if opt.player_handness is not None:
                if seq.get("handness") not in opt.player_handness:
                    continue
            elif opt.player_name is not None and \
                    seq.get("player") is not None and \
                    seq["player"] not in opt.player_name:
                continue
            base, length = seq["base"], seq["length"]
            entry: Dict = {
                "joint_pos": np.asarray(joint_pos[base:base + length],
                                        np.float32),
                "joint_rotmat": np.asarray(joint_rotmat[base:base + length],
                                           np.float32),
                "valid": np.asarray(valid[base:base + length], bool),
            }
            if opt.predict_phase:
                if not video.get("is_orig"):
                    continue   # phase labels need original point annotations
                kfs = video["points_annotation"][seq["point_idx"]]["keyframes"]
                start = seq.get("start", 0)
                hits = [(k["fid"] - start, bool(k["fg"])) for k in kfs]
                entry["hits"] = hits
            sequences.append(entry)
    if not sequences:
        raise ValueError(
            f"no sequences pass the filters in {dataset_dir}")
    return PoseSequenceDataset(opt, sequences, seed=opt.seed)


def write_video_dataset(dataset_dir: str, videos: Sequence[Dict]) -> None:
    """Inverse of `load_video_dataset` — packs per-sequence arrays into the
    manifest + flat npy layout (used by converters and test fixtures)."""
    import json
    import os

    os.makedirs(dataset_dir, exist_ok=True)
    manifest, jp, jr, vv = [], [], [], []
    base = 0
    for video in videos:
        v = {k: video[k] for k in
             ("name", "background", "gender", "is_orig")}
        v["sequences"] = {"fg": [], "bg": []}
        v["points_annotation"] = video.get("points_annotation", [])
        for side in ("fg", "bg"):
            for seq in video.get("sequences", {}).get(side, []):
                arrs = seq.pop("arrays")
                T = arrs["joint_pos"].shape[0]
                jp.append(np.asarray(arrs["joint_pos"], np.float32))
                jr.append(np.asarray(arrs["joint_rotmat"], np.float32))
                vv.append(np.asarray(arrs.get("valid", np.ones(T, bool))))
                v["sequences"][side].append({**seq, "base": base,
                                             "length": T})
                base += T
        manifest.append(v)
    np.save(os.path.join(dataset_dir, "joint_pos.npy"),
            np.concatenate(jp, axis=0))
    np.save(os.path.join(dataset_dir, "joint_rotmat.npy"),
            np.concatenate(jr, axis=0))
    np.save(os.path.join(dataset_dir, "valid.npy"),
            np.concatenate(vv, axis=0))
    with open(os.path.join(dataset_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def make_synthetic_pose_dataset(opt: MVAEOption, num_seqs: int = 4,
                                T: int = 120, seed: int = 0,
                                hit_period: int = 30) -> PoseSequenceDataset:
    """Smooth sinusoidal fake motions with alternating hit annotations — test
    and smoke-train fixture (the reference has no equivalent; its dataset
    requires the withheld video reconstructions)."""
    rng = np.random.default_rng(seed)
    J = opt.num_joints
    seqs = []
    for _ in range(num_seqs):
        t = np.arange(T)[:, None, None] / 30.0
        freq = rng.uniform(0.5, 2.0, (1, J, 3))
        phase0 = rng.uniform(0, 2 * np.pi, (1, J, 3))
        jp = 0.3 * np.sin(2 * np.pi * freq * t + phase0)
        jp[:, 0, 1] += 0.9  # root height
        jp[:, 0, 0] += np.linspace(0, 1.0, T)[:, None][..., 0]
        aa = 0.4 * np.sin(2 * np.pi * freq * t + phase0)
        rotmat = R.angle_axis_to_rotmat(
            torch.as_tensor(aa.reshape(-1, 3), dtype=torch.float32)).numpy()
        rotmat = rotmat.reshape(T, J, 3, 3)
        hits = [(f, (i % 2 == 0))
                for i, f in enumerate(range(2, T - 1, hit_period))]
        seqs.append({"joint_pos": jp.astype(np.float32),
                     "joint_rotmat": rotmat.astype(np.float32),
                     "hits": hits})
    return PoseSequenceDataset(opt, seqs, seed=seed)
