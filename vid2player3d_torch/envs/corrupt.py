"""Context corruption for the imitation task (PyTorch counterpart of
``envs/corrupt.py``).

The motion context fed to the imitation policy can be degraded as video
pose estimates are: fixed joint masking, Gaussian noise on a random subset of
joints with a confidence derived from the noise's size (joints whose
confidence falls below a floor count as occluded), and random joint dropout.
All three are `where` masks over fixed shapes. Each returns the corrupted
positions and a per-joint confidence; occluded and dropped joints are zeroed
in both. The root is never dropped.

The random draws come from a `torch.Generator`, or as tensors handed in
(`draws=`) so a test can feed the JAX package's: `sel_u` uniforms of the
confidence's shape (a joint is noisy where u < prob), `noise` standard
normals of the positions' shape, and `drop_u` uniforms (dropped where
u < prob).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.smpl import SMPL_BONE_ORDER_NAMES
from ..parallel.mesh import draw_rows, global_rows
from ..utils.runtime import as_draw

_SQRT3 = 1.7320508075688772


@dataclasses.dataclass(frozen=True)
class TransformSpecs:
    """Which corruptions to apply.

    mask_joints: zero out these named joints entirely.
    noisy_joints_*: Gaussian noise on a Bernoulli(prob) subset with a
      confidence from the normal cdf of the noise's size; joints whose
      confidence falls below `min_conf` are occluded (conf and position 0).
    mask_random_joints_prob: iid dropout of non-root joints.
    """
    mask_joints: Sequence[str] = ()
    noisy_joints_prob: float = 0.0
    noisy_joints_noise_std: float = 0.0
    noisy_joints_conf_std: float = 0.02
    noisy_joints_min_conf: float = 0.0
    mask_random_joints_prob: float = 0.0

    @property
    def active(self) -> bool:
        return (len(self.mask_joints) > 0 or self.noisy_joints_prob > 0.0
                or self.mask_random_joints_prob > 0.0)


def _draw(draws, name, shape, device, generator, normal=False, shard=None):
    """A standard draw of `shape` (leading env axis): handed in, or from
    `generator`; with a data-parallel `shard` both are global and this
    rank's rows are kept."""
    if draws is not None:
        full = shape if shard is None else (shard.num_envs,) + tuple(shape[1:])
        return global_rows(shard, as_draw(draws[name], torch.float32, device).reshape(full))
    fn = torch.randn if normal else torch.rand
    return draw_rows(shard, shape, lambda sh: fn(sh, generator=generator, device=device))


def corrupt_body_pos(body_pos: torch.Tensor, specs: Optional[TransformSpecs],
                     body_names: Sequence[str] = tuple(SMPL_BONE_ORDER_NAMES),
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict] = None, shard=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configured corruptions of (..., J, 3) joint positions, whose joint
    axis is ordered as `body_names`. Returns (corrupted positions, joint
    confidence (..., J)); with `specs=None` the identity with all-ones
    confidence. `shard` (a sharded env's `EnvShard`): the leading axis is
    this rank's block of the envs, the draws global."""
    conf = torch.ones(body_pos.shape[:-1], dtype=body_pos.dtype, device=body_pos.device)
    if specs is None or not specs.active:
        return body_pos, conf
    dev = body_pos.device

    if len(specs.mask_joints) > 0:
        idx = [list(body_names).index(j) for j in specs.mask_joints]
        conf[..., idx] = 0.0
        body_pos = body_pos * conf[..., None]

    if specs.noisy_joints_prob > 0.0:
        selected = _draw(draws, "sel_u", conf.shape, dev, generator, shard=shard) < specs.noisy_joints_prob
        std = torch.where(selected, specs.noisy_joints_noise_std, 0.0)
        noise = _draw(draws, "noise", body_pos.shape, dev, generator, True, shard) * std[..., None]
        noise_norm = torch.sqrt(torch.sum(noise * noise, dim=-1)) / (
            _SQRT3 * specs.noisy_joints_conf_std)
        new_conf = (1.0 - torch.special.ndtr(noise_norm)) * 2.0
        body_pos = body_pos + noise
        conf = torch.where(selected, new_conf, conf)
        occluded = conf < specs.noisy_joints_min_conf
        conf = torch.where(occluded, 0.0, conf)
        body_pos = torch.where(occluded[..., None], 0.0, body_pos)

    if specs.mask_random_joints_prob > 0.0:
        drop = _draw(draws, "drop_u", conf.shape, dev, generator, shard=shard) < specs.mask_random_joints_prob
        drop[..., 0] = False   # never drop the root
        conf = torch.where(drop, 0.0, conf)
        body_pos = torch.where(drop[..., None], 0.0, body_pos)

    return body_pos, conf
