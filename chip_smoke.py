#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vid2player3d_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one line (any failed phase exits non-zero):
  1. device   the card's name, the device count, and nvidia-smi's name and
              power limit
  2. build    nvcc builds every kernel of ``vid2player3d_torch/csrc`` for
              sm_90a (into ``build/kernels/``)
  3. K1       the fused clip+Adam kernel against its plain PyTorch version on
              the card, at the 16 full-width ImitatorNet leaf shapes, 4 steps,
              with f32 and with bf16 moments; its time per optimizer step
              beside its HBM bound, the plain version's time and
              `torch.optim.Adam(fused=True)` as a library yardstick
  4. parity   a small imitation epoch (4 envs, f32) on the card against the
              same epoch on the CPU with the same draws
  5. main     the slice's main path at full width: synthetic motion lib (8
              motions x 300 frames) -> HumanoidImEnv (4096 envs, 2 substeps)
              -> ImitationPPO (horizon 32, minibatch 512, 6 mini-epochs,
              fused_optimizer="on"), two `train_epoch`s, with the kernels'
              launch counters set to 0 just before and read just after
  6. profile torch.profiler over a short epoch at the same widths and env
              count: device busy and idle share, device events per env step
              and per optimizer step, the costliest device kernels
  7. kernels  one JSON line over the ported kernels
The last line is {"ok": true, "device": {...}}.

It needs a CUDA card and the repository around it: with no card, or run from
a directory that holds only this script, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# HBM rate by card name (NVIDIA data sheets); a PCIe part is slower
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                   ("H100", 3.35e12))
F32_FLOPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores

NUM_ENVS, HORIZON, SUBSTEPS, MINIBATCH, MINI_EPOCHS, EPOCHS = 4096, 32, 2, 512, 6, 2
K1_CHECK_STEPS = 4
K1_TIMED_STEPS = 200


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    fail(f"no HBM rate known for {name}")


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of `fn` in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version, and its times
# ---------------------------------------------------------------------------

def k1_phase(dev, card: str):
    import torch

    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.ops import fused_adam as FA

    net = ImitatorNet(num_actions=75, generator=torch.Generator().manual_seed(0))
    leaves = [p.detach().to(dev) for p in net.parameters()]
    n_params = sum(p.numel() for p in leaves)
    if len(leaves) != 16 or n_params != 4_693_068:
        fail(f"ImitatorNet has {len(leaves)} leaves / {n_params} params")
    gen = torch.Generator(device=dev).manual_seed(1)
    rate = hbm_rate(card)
    rows = {}
    for mdt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        # identical starting states for the kernel and the plain version
        pk = [p.clone() for p in leaves]
        pp = [p.clone() for p in leaves]
        mk = [torch.zeros_like(p, dtype=mdt) for p in leaves]
        vk = [torch.zeros_like(p, dtype=mdt) for p in leaves]
        mp = [m.clone() for m in mk]
        vp = [v.clone() for v in vk]
        count = torch.zeros((), dtype=torch.int32, device=dev)
        for step in range(K1_CHECK_STEPS):
            # global norm ~220 (clip active) on even steps, ~22 (no clip) on odd
            scale = 0.1 if step % 2 == 0 else 0.01
            grads = [torch.randn(p.shape, generator=gen, device=dev) * scale for p in leaves]
            scalars, count = FA.adam_scalars(grads, count, 2e-5, 50.0)
            for a in zip(pk, mk, vk, grads):
                FA.leaf_update(*a, scalars)
            for a in zip(pp, mp, vp, grads):
                FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
        err_p = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
        err_m = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(mk + vk, mp + vp))
        # both sides do the same f32 operations in the same order (the kernel
        # is built without FMA contraction; sqrt and division are IEEE-rounded
        # on both), so they agree to the last bit: 1e-7 only guards the check
        tol = 1e-7
        if not (err_p <= tol and err_m <= tol):
            fail(f"K1 {tag} disagrees with its plain version: p {err_p}, moments {err_m}")

        g = grads
        kernel_ms = cuda_ms(lambda: [FA.leaf_update(*a, scalars)
                                     for a in zip(pk, mk, vk, g)], K1_TIMED_STEPS)
        plain_ms = cuda_ms(lambda: [FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
                                    for a in zip(pp, mp, vp, g)], K1_TIMED_STEPS)
        step_ms = cuda_ms(lambda: FA.fused_clip_adam_apply(pk, mk, vk, g, count, 2e-5, 50.0),
                          K1_TIMED_STEPS)
        # the same 16 launches replayed from a CUDA graph: the device's time
        # without the host's per-launch cost
        graphs = []
        for fn in (lambda: [FA.leaf_update(*a, scalars) for a in zip(pk, mk, vk, g)],
                   lambda: [FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
                            for a in zip(pp, mp, vp, g)]):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            graphs.append(cuda_ms(graph.replay, K1_TIMED_STEPS))
        ms_bytes = torch.finfo(mdt).bits // 8
        nbytes = n_params * (4 + 4 + 4 + 2 * 2 * ms_bytes)   # p rw, g r, m v rw
        flops = n_params * 15
        bound_ms = max(nbytes / rate, flops / F32_FLOPS_PER_S) * 1e3
        rows[tag] = dict(max_abs_err=max(err_p, err_m), err_p=err_p, err_moments=err_m,
                         tol=tol, ms=kernel_ms, plain_ms=plain_ms, step_with_norm_ms=step_ms,
                         graph_ms=graphs[0], plain_graph_ms=graphs[1],
                         bound_ms=bound_ms, bytes=nbytes,
                         bound_by="bytes" if nbytes / rate >= flops / F32_FLOPS_PER_S
                         else "operations")

    # library yardstick: one fused Adam step over the same f32 leaves (no
    # clip scale, f32 moments)
    lp = [p.clone().requires_grad_(True) for p in leaves]
    for p in lp:
        p.grad = torch.randn(p.shape, generator=gen, device=dev) * 0.01
    opt = torch.optim.Adam(lp, lr=2e-5, eps=1e-8, fused=True)
    library_ms = cuda_ms(opt.step, K1_TIMED_STEPS)
    for tag in rows:
        rows[tag]["library_ms"] = library_ms
        say("K1", moments=tag, card=card, n_params=n_params, leaves=16,
            launches_per_step=16, tol=rows[tag]["tol"], max_abs_err=rows[tag]["max_abs_err"],
            err_p=rows[tag]["err_p"], err_moments=rows[tag]["err_moments"],
            kernel_ms_per_step=rows[tag]["ms"], plain_ms_per_step=rows[tag]["plain_ms"],
            step_with_norm_ms=rows[tag]["step_with_norm_ms"],
            graph_replay_ms=rows[tag]["graph_ms"], plain_graph_replay_ms=rows[tag]["plain_graph_ms"],
            bound_ms=rows[tag]["bound_ms"], bound_bytes=rows[tag]["bytes"],
            hbm_bytes_per_s=rate,
            library_ms=library_ms,
            library="torch.optim.Adam(fused=True).step(), f32 moments, no clip scale")
    return rows


# ---------------------------------------------------------------------------
# phase 4: a small epoch on the card against the CPU
# ---------------------------------------------------------------------------

# rollout metrics see the stiff physics through four control steps, whose
# one-ulp differences (another order of float sums on the card) grow from
# step to step; the same tolerances hold the CPU port against the JAX package
PARITY_ATOL = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-6, "kl": 1e-5,
               "clip_frac": 1e-6, "lr": 0.0}


def parity_phase(dev):
    import numpy as np
    import torch

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    n, t, mb, me = 4, 4, 8, 2
    rng = np.random.RandomState(0)
    draws = {"motion_times": (rng.rand(n) * 0.8).astype(np.float32),
             "noise": rng.randn(t, n, 75).astype(np.float32),
             "perms": np.stack([rng.permutation(n * t) for _ in range(me)])}
    metrics = {}
    for d in ("cpu", dev):
        lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=d)
        env = HumanoidImEnv(HumanoidImConfig(num_envs=n, substeps=2), lib,
                            motion_ids=np.array([0, 1, 1, 0]), device=d)
        agent = ImitationPPO(env, PPOConfig(horizon=t, minibatch_size=mb, mini_epochs=me,
                                            compute_dtype="f32", fused_optimizer="on"),
                             seed=7, device=d)
        _, m = agent.train_epoch(agent.init_state(), draws=draws)
        metrics[str(d)] = {k: float(v) for k, v in m.items()}
    ref, got = metrics["cpu"], metrics[str(dev)]
    worst = {}
    for k in ref:
        err = abs(got[k] - ref[k])
        worst[k] = err
        if not err <= PARITY_ATOL.get(k, 1e-5) + 1e-4 * abs(ref[k]):
            fail(f"card and CPU epochs disagree on {k}: {got[k]} vs {ref[k]}")
    say("parity", envs=n, horizon=t, metric_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_phase(dev, card: str):
    import math

    import torch

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig
    from vid2player3d_torch.ops import fused_adam as FA

    t0 = time.perf_counter()
    lib = make_synthetic_motion_lib(num_motions=8, T=300, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=NUM_ENVS, substeps=SUBSTEPS), lib,
                        rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=HORIZON, minibatch_size=MINIBATCH,
                                        mini_epochs=MINI_EPOCHS, fused_optimizer="on"),
                         seed=7, device=dev)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    leaves = len(ts.params)
    steps_per_epoch = agent.num_minibatches * MINI_EPOCHS

    torch.cuda.reset_peak_memory_stats()
    FA.leaf_update.launches = 0
    epoch_s, rows = [], []
    for _ in range(EPOCHS):
        t0 = time.perf_counter()
        ts, m = agent.train_epoch(ts)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in m.items()})
    launches = FA.leaf_update.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    expected = EPOCHS * steps_per_epoch * leaves
    if launches != expected:
        fail(f"K1 launched {launches} times on the main path, expected {expected}")
    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"epoch {i}: non-finite metrics {bad}")
        if not r["alive_ratio"] > 0.5:
            fail(f"epoch {i}: alive_ratio {r['alive_ratio']}")
    if int(ts.opt_state.count) != EPOCHS * steps_per_epoch:
        fail(f"optimizer count {int(ts.opt_state.count)}")

    # the rollout alone (policy forward + env step, no update), for env-steps/s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = agent.rollout(ts)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    if not bool(torch.isfinite(traj["obs"]).all()):
        fail("rollout obs not finite")

    say("main", card=card, envs=NUM_ENVS, horizon=HORIZON, substeps=SUBSTEPS,
        minibatch=MINIBATCH, mini_epochs=MINI_EPOCHS, epochs=EPOCHS, cut="none",
        compute_dtype=str(agent.compute_dtype), n_params=sum(p.numel() for p in ts.params.values()),
        setup_s=setup_s, epoch_s=epoch_s, rollout_s=rollout_s,
        rollout_env_steps_per_s=NUM_ENVS * HORIZON / rollout_s,
        epoch_env_steps_per_s=NUM_ENVS * HORIZON / epoch_s[-1],
        optimizer_steps_per_epoch=steps_per_epoch, k1_launches=launches,
        peak_mem_gib=peak_gib, metrics=rows)
    return launches


# ---------------------------------------------------------------------------
# phase 6: where the time goes (torch.profiler over a short epoch)
# ---------------------------------------------------------------------------

def _device_events(prof):
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_phase(dev, card: str):
    """One short epoch at the main path's widths and env count (horizon 2,
    one mini-epoch: 2 env steps and 16 optimizer steps), profiled after a
    warm-up; and its rollout alone. Device busy time is the sum of the
    device events (one stream, so they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    lib = make_synthetic_motion_lib(num_motions=8, T=300, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=NUM_ENVS, substeps=SUBSTEPS), lib,
                        rng=0, device=dev)
    horizon = 2
    agent = ImitationPPO(env, PPOConfig(horizon=horizon, minibatch_size=MINIBATCH,
                                        mini_epochs=1, fused_optimizer="on"),
                         seed=7, device=dev)
    ts, _ = agent.train_epoch(agent.init_state())
    out = {}
    for name, fn in (("rollout", lambda: agent.rollout(ts)),
                     ("epoch", lambda: agent.train_epoch(ts))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = _device_events(prof)
        busy = sum(e.time_range.elapsed_us() for e in evs) * 1e-6
        by_name = {}
        for e in evs:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = dict(wall_s=wall, device_busy_s=busy if evs else "not measured",
                         device_idle_share=(1.0 - busy / wall) if evs else "not measured",
                         device_events=len(evs),
                         top_device_s={k[:60]: v for k, v in top})
    steps = agent.num_minibatches
    r, e = out["rollout"], out["epoch"]
    say("profile", card=card, envs=NUM_ENVS, horizon=horizon, optimizer_steps=steps,
        device_events_per_env_step=r["device_events"] / horizon,
        device_events_per_optimizer_step=(e["device_events"] - r["device_events"]) / steps,
        update_wall_s_per_optimizer_step=(e["wall_s"] - r["wall_s"]) / steps,
        rollout_wall_s_per_env_step=r["wall_s"] / horizon, **out)


def main() -> None:
    if not os.path.isdir(os.path.join(REPO, "vid2player3d_torch")):
        fail(f"no vid2player3d_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("device", name=card, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    from vid2player3d_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_kernels()
    say("build", seconds=time.perf_counter() - t0, built=sorted(logs),
        ptxas={k: [ln for ln in v.splitlines() if "registers" in ln] for k, v in logs.items()})

    k1 = k1_phase(dev, card)
    parity_phase(dev)
    launches = main_phase(dev, card)
    profile_phase(dev, card)

    row = k1["bf16"]   # the main path's moment type on the card
    kernels = [{"name": "fused_clip_adam", "route": "cuda",
                "source": "vid2player3d_torch/csrc/fused_adam.cu",
                "replaces": "vid2player3d_tpu/ops/fused_adam.py:66",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "unit": "one optimizer step over the 16 ImitatorNet leaves, bf16 moments",
                "graph_ms": row["graph_ms"], "plain_graph_ms": row["plain_graph_ms"],
                "f32_moments": {k: k1["f32"][k] for k in
                                ("max_abs_err", "ms", "plain_ms", "bound_ms", "graph_ms",
                                 "plain_graph_ms")}}]
    say("total", seconds=time.perf_counter() - t_start)
    print("nvidia-smi: " + nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
