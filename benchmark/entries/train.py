"""The training entry: whole `train_epoch` calls of the named config.

Set-up builds the learner through the port's command line, on the
benchmark's inputs and weights, and drives it through its first
`checked_epochs` epochs; the first captures the CUDA graphs. The window then
runs the same learner's epochs until `--seconds` have passed, each ending in
a synchronize, and `train_env_steps_per_s` is all their env-steps over all
their time. After the window the port's state is freed and the reference
runs the checked epochs on the same inputs, weights and draws.
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from types import SimpleNamespace

import torch

from .. import check, metrics as layer_metrics, trace
from ..device import memory_peak, sync
from ..reference import train as ref_train


def _captures(agent) -> list:
    st = getattr(agent, "_st", None)
    return [getattr(getattr(st, g, None), "captures", None) for g in ("step", "update")]


def checked_epochs(kind, cfg: dict, traffic: dict, inputs: dict, device, num_envs=None):
    """Build the port's learner on the benchmark's inputs and weights and
    drive it through its first `checked_epochs` epochs, through the
    window's own call: (learner, train state, the readings the reference
    is held to, the initial params)."""
    agent, ts = kind.build_program(cfg, inputs, device, num_envs)
    params0 = {k: v.detach().clone() for k, v in ts.params.items()}
    prog = {"losses": [], "rewards": [], "grads": [], "params": [], "names": list(ts.params)}
    for _ in range(traffic["checked_epochs"]):
        ts, m = agent.train_epoch(ts)
        ref_train.record(prog, ts, m, cfg["ppo"])
    return agent, ts, prog, params0


def run(cell: dict, cfg: dict, traffic: dict, kind, seed: int, seconds: float, traced: bool,
        device, setup_start: float, log, per_layer=(), num_envs=None) -> SimpleNamespace:
    """One run of a training cell (`num_envs`, where given, replaces the
    config's: the CPU tests run the harness at a small size)."""
    ppo = cfg["ppo"]
    envs = num_envs or cfg["env"]["num_envs"]
    steps_per_epoch = envs * ppo["horizon"]
    opt_steps = ppo["mini_epochs"] * (steps_per_epoch // ppo["minibatch_size"])
    with tempfile.TemporaryDirectory(prefix="bench_inputs_") as work:
        inputs = kind.make_inputs(cfg, seed, work)
        agent, ts, prog, params0 = checked_epochs(kind, cfg, traffic, inputs, device, num_envs)
        sync(device)
        setup_s = time.time() - setup_start
        captures_setup = _captures(agent)
        log(f"setup_s {setup_s:.3f}; checked epochs' losses {prog['losses']}; "
            f"captures {captures_setup}")

        spans = trace.Spans()
        if traced:
            spans.wrap(agent, "_rollout_graphed", "rollout")
            spans.wrap(agent, "_update_graphed", "update")
        losses = []
        t0 = time.perf_counter()
        while True:
            ts, m = agent.train_epoch(ts)
            losses.append(m["c_loss"])
            sync(device)
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
        epochs = len(losses)
        captures_window = _captures(agent)
        metrics = {}
        result = SimpleNamespace(attempted=epochs,
                                 failed=sum(not math.isfinite(float(x)) for x in losses))
        if not traced:
            metrics["train_env_steps_per_s"] = {
                "value": epochs * steps_per_epoch / window_s, "unit": "env-steps/s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            spans.unwrap()
            before = trace.launches()
            prof = trace.profile(lambda: agent.train_epoch(ts))
            result.profile = prof
            ctx = SimpleNamespace(
                cell=cell, cfg=cfg, agent=agent, spans=spans.times, profile=prof,
                launches={k: v - before.get(k, 0) for k, v in trace.launches().items()},
                window=dict(units=epochs, seconds=window_s, horizon=ppo["horizon"], envs=envs,
                            env_steps=steps_per_epoch, opt_steps=opt_steps,
                            flops=kind.flops_per_epoch(cfg, num_envs)))
            metrics = layer_metrics.read(per_layer, ctx)
        log(f"window: {epochs} epochs in {window_s:.3f} s; captures {captures_window}")
        result.memory_peak_bytes = memory_peak(device)

        # the port's state goes before the reference runs
        del agent, ts, m
        ctx = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = ref_train.run_epochs(kind, cfg, inputs, params0, traffic["checked_epochs"], device,
                                   num_envs=num_envs)
        log(f"reference: {traffic['checked_epochs']} epochs in {time.perf_counter() - t:.3f} s; "
            f"losses {ref['losses']}")
    numbers = check.train_numbers(prog, ref, params0)
    log(f"all readings {numbers}")
    result.metrics = metrics
    result.numbers = numbers
    return result
