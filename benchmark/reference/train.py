"""The reference's first training epochs, from the benchmark's inputs and
weights, for the comparison that decides a training cell's `correct`."""

from __future__ import annotations

from typing import Dict, List

import torch

from .port.learn.optim import init_adam
from .precision import fp8_trunks


def epoch_loss(metrics: Dict[str, torch.Tensor], ppo: dict) -> float:
    """The epoch's PPO loss as its optimizer steps' mean: the surrogate, the
    weighted value loss and the weighted bounds loss."""
    return float(metrics["a_loss"] + ppo["critic_coef"] * metrics["c_loss"]
                 + ppo["bounds_loss_coef"] * metrics["b_loss"])


def leaf_grad_norms(nu: List[torch.Tensor]) -> List[float]:
    """Each leaf's gradient norm as Adam holds it: the root of the sum of its
    second moment (the mean square of the clipped gradients it was given)."""
    return [float(v.float().sum().sqrt()) for v in nu]


def half_batch(agent) -> None:
    """A fault: every minibatch's second half left out of the loss, whose
    means are taken over the rest."""
    loss = agent._loss

    def faulty(params, batch, obs_norm, *a, **kw):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return loss(params, half, obs_norm, *a, **kw)

    agent._loss = faulty


def run_epochs(kind, cfg: dict, inputs: dict, params0: Dict[str, torch.Tensor], epochs: int,
               device, control: bool = False, num_envs=None, fault=None) -> dict:
    """`epochs` reference epochs in float32 with TF32 off (`control`: the
    trunks in fp8; `fault`: a function that breaks the learner): each
    epoch's loss, the leaves' gradient norms and the params after it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.detach().clone() for k, v in params0.items()}
    agent, ts, nets = kind.build_reference(cfg, inputs, device, params, num_envs)
    if cfg["precision"]["adam_moments"] == "bfloat16":
        # the configuration keeps Adam's moments in bf16 (the arithmetic in
        # f32): a stated part of the optimizer, held by the reference too
        ts.opt_state = init_adam(list(ts.params.values()), torch.bfloat16)
    if control:
        for net in nets:
            fp8_trunks(net)
    if fault is not None:
        fault(agent)
    out = {"losses": [], "rewards": [], "grads": [], "params": [], "names": list(ts.params)}
    for _ in range(epochs):
        ts, m = agent.train_epoch(ts)
        record(out, ts, m, cfg["ppo"])
    return out


def record(out: dict, ts, metrics, ppo: dict) -> None:
    """One epoch's readings: its loss, its rollout's mean reward, the
    leaves' gradient norms and the params after it."""
    out["losses"].append(epoch_loss(metrics, ppo))
    out["rewards"].append(float(metrics["reward_mean"]))
    out["grads"].append(leaf_grad_norms(ts.opt_state.nu))
    out["params"].append({k: v.detach().clone() for k, v in ts.params.items()})
