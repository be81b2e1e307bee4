#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vid2player3d_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one line with the script's seconds so far (`at_s`)
and the phase's own (`since_last_s`; any failed phase exits non-zero):
  1. device   the card's name, the device count, and nvidia-smi's name and
              power limit
  2. build    nvcc builds every kernel of ``vid2player3d_torch/csrc`` for
              sm_90a (into ``build/kernels/``), all sources in parallel
  3. K1       the fused clip+Adam step at the 16 full-width ImitatorNet
              leaves, 4 steps, f32 and bf16 moments: the multi-tensor update
              bit for bit with its plain version under the same scalars, the
              norm kernel's scalars against `adam_scalars` (relative 1e-6),
              the step count exact, 2 launches per step; times (eager and
              graph) of the step, the update and the norm beside their HBM
              bounds, the plain versions' and `torch.optim.Adam(fused=True)`'s
              (eager and graph), and the wrapper's host cost per step
  4. K2       moe_linear against its plain version at the MVAE decoder's three
              full-width layers (E = 6; 320->256, 288->256, 288->290) at
              B = 15,360 (the stage-2 decode), 10,240, 7,680 (one lane's
              decode in the dual rally), 1,001, 255, 100 (the MotionVAE
              trainer's batch) and 1, its prep kernel
              bit for bit with the plain TF32 split, its backward against
              autograd at B = 256 and 100; its tiling;
              time per decode (3 prep + 3 GEMM launches) at B = 10,240,
              7,680 and 15,360, eager and as a CUDA-graph replay beside the 3xTF32 and
              f32 SIMT bounds, the plain version's, and one cuBLAS GEMM per
              layer of the same FLOPs (no blend, eager and graph) as a library
              yardstick
  5. K3       fk_chain bit for bit with its plain version at N = 1, 255, 256,
              257, 10,240, 15,360 and 30,720 (MuJoCo tree), 10,240 (SMPL tree)
              and on views 4 bytes past a 16-byte boundary, one launch per
              call; the MuJoCo tree on its straight-line build;
              times at N = 10,240, 15,360, 30,720 and 256, eager and as a graph
              replay, warm (one input set again and again) and cold (input
              and output sets over 4x the L2, taken in turn), the cold time
              beside the HBM bound, and the wrapper's host cost per call
  6. parity   a small imitation epoch (4 envs, f32) on the card against the
              same epoch on the CPU with the same draws
  7. main     the imitation path at full width: synthetic motion lib (8
              motions x 300 frames) -> HumanoidImEnv (4096 envs, 2 substeps)
              -> ImitationPPO (horizon 32, minibatch 512, 6 mini-epochs,
              fused_optimizer="on"), one `train_epoch` (cut from two; every
              env step and optimizer step replayed from a CUDA graph), K1's
              two launch counters set to 0 just before and read just after
  8. graphs   the epochs replayed from CUDA graphs (`utils/graphs.py`)
              against their eager bodies on the same draws: the imitation
              epoch on phase 6's case and at phase 7's sizes (params,
              moments, norms and metrics: bit for bit, or each difference
              printed and held to tests/test_torch_epoch.py's bounds), the
              rollout alone graphed and twice eager (where it differs),
              graphed and eager epoch, rollout and optimizer-step times,
              each graph's capture and instantiate seconds, node count and
              pool, K1's launches per epoch through the replays, the
              device's idle share over one graphed epoch (profiler);
              mvae_federer at full
              width, 16 windows with fuse=16, fuse=1 and eagerly: losses and
              params bit for bit, ms per optimizer step, the window graph,
              K2's launches through the replays
  9. tennis parity  a small tennis epoch (4 envs, horizon 4, f32) on the card
              against the same epoch on the CPU with the same draws
  10. tennis main    the tennis path at federer_train_stage_1's sizes: random
              full-width MVAE (hidden 256, 6 experts) and pi_low
              (734->1024->1024->512->75), a 4096-candidate ball pool,
              TennisEnv (10,240 envs, 2 substeps, reach reward, 256 candidate
              resets) -> V2PPPO (horizon 64, minibatch 16,384, 6 mini-epochs:
              240 optimizer steps per epoch), two `train_epoch`s, every env
              step and optimizer step replayed from a CUDA graph (the first
              epoch captures both graphs); the K2 (prep and GEMM) and K3
              launch counters set to 0 just before each epoch and read just
              after; epoch, rollout and optimizer-step times, each graph's
              nodes, capture and instantiate seconds and pool
  11. stage2  8 `TennisEnv.step`s at federer_train_stage_2's env (15,360
              envs, 6 substeps, wrist reaction force, ball-body contact,
              return_w_estimate) with the same networks; K3's counter set to
              0 before its `reset_all` (1 launch) and read after the steps
              (2 launches each: the step's FK targets and the candidate reset)
  11b. tennis graphs  the graphed tennis epoch against the eager one: at 8
              envs what differs between two eager epochs and a graphed one
              (the contact sums' atomics); under deterministic algorithms
              graphed and eager bit for bit (8 envs, two epochs; 10,240 envs,
              one of horizon 8) and two eager epochs equal; one graphed stage-2 epoch at
              15,360 envs (horizon 32, 180 optimizer steps) with its times,
              graphs and K2/K3 launches, finite with grad_skip 0; the
              device's idle share over one more graphed stage-1 epoch
              (profiler)
  12. dual parity  a small dual-rally epoch (8 envs, two players: a
              left-handed two-hand lane and a right-handed one, two policies,
              horizon 4, f32) on the card against the same epoch on the CPU
              with the same draws
  13. dual main     the dual rally as `nadal_federer` builds it: DualTennisEnv
              (15,360 envs, 6 substeps, return_w_estimate, continuous
              targets, wrist reaction force, ball-body contact, the full
              masked reset) with two random full-width MVAEs (nadal
              left-handed with the two-hand backhand, federer) and two random
              full-width pi_low -> V2PPPO(num_policies=2) (horizon 32,
              minibatch 16,384, 6 mini-epochs: 180 optimizer steps per epoch,
              lr 1e-5, sigma_init -2.9), two `train_epoch`s, every env step
              and optimizer step replayed from a CUDA graph (the first epoch
              captures both), the K2 and K3 launch counters set to 0 just
              before each epoch and read just after (6 + 6 and 2 per env
              step); epoch, rollout and optimizer-step times, the graphs'
              nodes, pools, capture and instantiate seconds, peak memory;
              the two-hand IK alone at 15,360 rows, eager and replayed from a
              graph, ms per call
  13b. dual graphs  the graphed dual epoch against the eager one under
              deterministic algorithms, bit for bit (metrics, params,
              moments, both norms, env state, last obs): 8 envs over two
              epochs of 4 steps (and two eager epochs alike), 15,360 envs over
              one epoch of horizon 4
  13c. twohand main  `nadal` (left-handed, the two-hand backhand; stage 3 at
              its 30,720 envs, 256 candidate resets) -> V2PPPO (horizon 32,
              360 optimizer steps), one graphed epoch, K2 (3 + 3) and K3 (2)
              per env step counted through the replays; K2 at B = 30,720 and
              K3 at N = 30,720 and 256 held to their plain versions on the
              inputs one more step gives them, K2 timed there beside its
              bound and cuBLAS; the IK alone at 30,720 rows, eager and as a
              graph, the graphed result against the eager one
  14. dr parity  a small amass_im_dr imitation epoch (4 envs, f32, from epoch
              300 so the scheduled noise is on) and a small
              federer_train_stage_1_dr tennis epoch (8 envs, test widths) on
              the card against the CPU with the same draws
  15. ctx parity  a small amass_im_corrupt epoch (4 envs, f32, 24 leaves) on
              the card against the CPU, and the context IK alone at B = 512
              (outputs and the gradient into the heads)
  16. im dr main    amass_im_dr at phase 7's sizes, two epochs replayed
              from CUDA graphs (the first captures, the second runs under
              `set_sync_debug_mode("error")`): K1's launches through the
              replays, the captures per epoch, the graphs' nodes, capture
              and pool, each epoch's perturbed model against the base and
              the other's, the schedule's strength
  17. im ctx main   amass_im_corrupt at phase 7's sizes, two epochs of 2
              mini-epochs (cut from 6; 24 leaves) replayed the same way:
              K1's launches, finite auxiliary losses; the context IK alone
              per rollout step and per optimizer step, eager (host syncs:
              0) and replayed from a graph, and its share of the steps
  18. tennis dr main  federer_train_stage_1_dr at its own sizes (10,240 envs,
              the federer MVAE width), two epochs replayed the same way:
              K2's and K3's launches through the replays, grad_skip 0, each
              epoch's ball constants
  18b. ctx dr graphs  amass_im_corrupt, amass_im_dr (from epoch 300) and
              federer_train_stage_1_dr (from epoch 300) at 8 envs: the
              graphed epochs against eager ones over two epochs under
              deterministic algorithms, bit for bit
  19. ckpt    the port's checkpoints in the JAX package's layout: the
              tennis_main learner's save -> load bit for bit;
              `load_stage_checkpoint` of that file into a stage-2 learner on
              phase 11's env (every leaf carried, lr dropped to stage 2's)
              and 8 finite warm-started steps with K3 counted (1 + 2 per
              step); the dual learner's warm start from the same file (each
              lane the single policy); the main imitation learner's file
              (bf16 moments) round-tripped; tennis_main's ball pool and
              main's motion library round-tripped on the card; save and load
              times
  20. mvae parity  two small MotionVAE epochs (hidden 64, 3 experts, batch
              8) on the card against the CPU with the same draws
  21. mvae main    mvae_federer at full width (frame 288 -> 290 outputs,
              latent 32, hidden 256, 6 experts, batch 100, 10-frame
              windows) on a synthetic pose dataset, 2 epochs x 50 windows
              (900 optimizer steps; `train_epoch(fuse=16)`, each window
              replayed from a CUDA graph) from epoch 75, K2's counters set to 0
              just before and read just after (2,700 prep + 2,700 GEMM); the
              forward/backward/Adam split per optimizer step and the device's
              idle share over one window, replayed and eager; K2 at B = 100
              (forward and backward held to the plain version on the inputs
              it times;
              eager and graph, bound, cuBLAS yardstick, backward); save -> a
              fresh trainer's load -> `spec_from_trainer` -> the 120-step
              random-walk report (8 envs); 8 TennisEnv steps at 10,240 envs
              driven by the trained spec (K2 3 + 3, K3 2 per step)
  22. cli     the README's curriculum through the port's entry points, in a
              directory under build/: `python -m vid2player3d_torch --cfg
              mvae_federer --epochs 1 --mvae_batches 20` as a process of its
              own (the MotionVAE at full width) beside `--cfg federer_im
              --num_envs 4096 --epochs 1` in this one (best.npz,
              metrics.jsonl; K1 one norm and one update per optimizer step:
              `fused_optimizer="auto"` takes K1 on the card);
              then, alone, `--cfg federer_train_stage_1 --epochs 1`
              at its own 10,240 envs, which must embed federer_im/best.npz
              and the trained MotionVAE with its init frames, K2's and K3's
              counters set to 0 just before the call and read just after:
              the epoch exactly tennis_main's 192 + 192 and 128, the rest of
              the call (init_state's reset) 1 K3, grad_skip 0; `--test
              --render --select_best` of that stage from its best.npz at 64
              envs beside `--cfg nadal_federer --test --render` at 64 envs
              in a process of its own (both host-bound):
              finite reports with the JAX eval's keys (per lane for the dual
              rally), both HTML files with their envs, seconds per eval
              step; the pool CLI with `--backend native` and `--backend
              torch` at 100,000 candidates, both files loaded on the card,
              the common survivors' launch states identical, the sizes
              within 5%, both wall times
  23. dp parity  (beside phase 24's processes; its wall time is printed as
              overlapped) two gloo ranks share the card (spawned processes, the
              learners' `mesh=` over envs sharded with `shard`; the group's
              mesh without a device on the card each rank pinned): small f32
              imitation epochs (global minibatch with K1; per-rank
              minibatches with local SGD), a stage-1 tennis epoch (2
              candidate resets, episodes of 3 steps) and a dual rally with
              two policies and per-rank minibatches, on global draws; the
              rollout metrics against one process on the card to 1e-5
              relative, the params against it (the union minibatches; local
              SGD against two gloo ranks on the CPU) at the CPU epoch tests'
              tolerances (imitation within 1% of the update's norm), params
              and moments bit for bit across the ranks, each kernel's
              launches per rank, and K1, K2 and K3 against their plain
              versions on each rank's own inputs, at each of their shapes
  24. dp cli  `python -m vid2player3d_torch --cfg amass_im --n_devices 1
              --num_envs 4096 --epochs 1` over NCCL at world size 1 (its
              checkpoint read back), beside `--n_devices 2`, which must exit
              non-zero with both counts; both start before dp parity and
              run beside it
  25. dp main two gloo ranks on the card at full widths: amass_im at
              2 x 2048 envs in both sync modes (horizon cut to 8; global
              minibatch 512 with K1, 1 mini-epoch, cut from 6; per-rank
              minibatches of 512 with local SGD, 2 mini-epochs, cut from 6),
              federer_train_stage_1 at 2 x 2048 (horizon cut to 8) and
              nadal_federer at 2 x 256 (per-rank minibatches of 1024,
              horizon cut to 4): per rank and path the epoch, the rollout's
              env-steps/s, the gradient all-reduce's ms per optimizer step
              and share of the update, the local-SGD sync's ms per
              mini-epoch, each kernel's launches against one process's count,
              and K1, K2 and K3 against their plain versions on the inputs
              each rank's epoch gave them, at every shape (K2 at the rank's
              envs per lane, K3 at its envs and at the 256 candidate resets)
  26. data    the host-side data tools at the sizes users run them, in a
              directory under build/: an AMASS-layout directory (32 SMPLH
              clips, 1200 frames at 120 Hz, mixed genders, one clip too short
              and one broken file) through `convert_amass_dir` on the card
              and on the CPU (32 motions at 30 fps; every field within 1e-5;
              `get_motion_state` at 4096 random times within 1e-5 plus twice
              the CPU's float32 gap to float64), its saved file read back into
              one amass_im epoch at phase 7's sizes (K1 1,536 + 1,536);
              `python -m vid2player3d_torch.data.tennis_motion` at its
              defaults (96 sequences x 6 cycles), then `--cfg mvae_federer
              --dataset_dir` on it in this process (1 epoch x 50 windows at
              full width; K2 3 prep + 3 GEMM per optimizer step in the epoch,
              and in the 120-step random-walk report after it); the tennis
              motion library (32 sequences x 5 cycles) built on the card and
              on the CPU (every field within 1e-5) and `--cfg federer_im
              --motion_file` on it at 4096 envs for one epoch; a 24-joint
              FBX chain written as ASCII and as binary, both imported and
              equal, retargeted onto the humanoid tree into a library on the
              card with finite states; each step's seconds
  26b. learn the JAX package's learning checks through the graphed trainers
              at full width, each failing the script when it is not met: L1
              amass_im as `cli/run.py` `_build_im` builds it at 2048 envs
              with fused_optimizer="on", 60 epochs (the amass_im_500ep
              artifact's command cut from 500): every metric finite,
              alive_ratio over the last 10 epochs at least 0.08 above epochs
              1-10's, c_loss over epochs 6-10 at most half of epoch 1's, K1 2
              launches per optimizer step through the replays, no capture
              after epoch 1, epochs 1, 10, 50 and 80 printed beside the JAX
              package's committed TPU run; L2 `eval_imitation` (graphed) of
              the trained params against the initial ones (pure-PD parity)
              on the same fed reset times: success_rate higher; L3
              tests/test_pi_low.py's tracking curve at its 64 envs (25
              graphed epochs with K1): the error falls, ends below pure PD's;
              L4 mvae_federer, 4 epochs of 500 windows on the data phase's
              generated dataset: recon at epoch 4 at most a quarter of epoch
              1's, K2 3 + 3 per optimizer step through the window replays; L5
              L1's policy as the frozen pi_low of federer_train_stage_1 at
              10,240 envs, 2 graphed epochs: finite, grad_skip 0, K2 192 +
              192 and K3 128 per epoch
  26c. scripts the system's own scripts (``vid2player3d_torch/scripts``):
              `swing_quality` at its defaults (8 sequences, seed 3) on the
              card against the same call on the CPU (the contacts equal,
              the speeds to 1e-4 relative, the net-clear and bounce-in rates
              within one ball); `e2e_curriculum` in a directory under build/
              at a cut depth (10 imitation epochs at its 64 envs, horizon
              16; the MotionVAE's pre-run of 5 epochs x 2 windows; stage 1
              at its 16 envs for 2 epochs; both evaluations and the render
              at the script's sizes): every leg exits 0, the report has the
              keys of artifacts/e2e/e2e_report.json with finite numbers,
              rollout.html written; the K1, K2 (prep and GEMM) and K3
              counters set to 0 just before the curriculum and read just
              after, K2 and K3 launched
  26d. hit    the hitting curriculum (artifacts/torch_tennis_hit/) through
              `cli.run.main` in a directory under build/, on the `learn`
              phase's amass_im policy (L1) and MotionVAE (L4, trained on the
              `data` phase's generated rig dataset): federer_train_stage_1a
              at 2048 envs for 3 epochs, federer_train_stage_1 for 1 from
              its checkpoint, federer_train_stage_2a and federer_train_serve
              (4096 envs) for 1 each by their configs' warm start, `--test`
              of the 2a checkpoint at 1024 envs for 64 steps; each call's
              K2 and K3 counters set to 0 just before and read just after
              (3 + 3 and 2 per env step, 1 K3 per reset); every metric
              finite and grad_skip 0 (H6), the report's JAX keys (H5); every
              ball of the stage-1a and 2a pools bounces within 1 m in x of
              the player's start; the serve toss starts above the free hand;
              K2 at B = 2048, 4096 and 1024 and K3 at N = 2048 (cold) held
              to their plain versions and timed beside their bounds and
              cuBLAS. `hit_checks` and `serve_checks` score the full-length
              runs (tests/test_torch_hit.py)
  27. physics the engine's public API: `substep` on the card against the CPU on
              the 6-env humanoid case (self-collision on; a free base with
              root wrenches, a fixed base, extra wrenches; 1 and 4 substeps)
              to 5e-6 (positions, quaternions) and 2e-4 (velocities); the
              five physical properties of tests/test_physics.py with its
              thresholds on every one of 4096 envs (free fall, momentum, the
              fixed-base pendulum's period on the two-body model; the
              humanoid's drop-and-stand and self-collision deflection);
              each run's step replayed from a CUDA graph; `substep`'s and
              `control_step(substeps=4)`'s ms per call at 4096 envs, with
              self-collision off and on, eager (synchronized host clock) and
              as a graph replay (CUDA events)
  28. profile torch.profiler over a short imitation epoch, a short tennis
              rollout and one dual step (both replayed from their graphs,
              captured first): device busy and idle share,
              device events per step, the costliest device kernels, K2's and
              K3's device share and, from the port's tracer, the device
              share of the step's parts (masked_reset, estimate_out,
              two_hand, and the dual env's serve and handoff)
  29. kernels one JSON line over the ported kernels, each kernel's launches
              on every main path it runs on
The last line is {"ok": true, "device": {...}}.

It needs a CUDA card and the repository around it: with no card, or run from
a directory that holds only this script, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib
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
TF32_FLOPS_PER_S = 495e12    # H100 SXM, TF32 tensor cores, dense

# the imitation phases' sizes; `main` runs one epoch (cut from two to keep the
# whole run inside its time limit on slow hosts), slice 4's imitation phases two
NUM_ENVS, HORIZON, SUBSTEPS, MINIBATCH, MINI_EPOCHS, EPOCHS = 4096, 32, 2, 512, 6, 1
# slice 4's main phases, replayed from graphs: the first epoch captures, the
# second replays under the sync check; im_ctx_main's epochs cut from 6
# mini-epochs to 2 (512 optimizer steps each)
SLICE4_EPOCHS = 2
CTX_MINI_EPOCHS = 2
K1_CHECK_STEPS = 4
# the tennis step's parts (`utils/trace.py`; the dual env's serve runs inside
# the masked reset)
SPANS = ("masked_reset", "estimate_out", "two_hand", "serve", "handoff")
K1_TIMED_STEPS = 200


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


_LAST_SAID = [T_START]


def say(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far (`at_s`) and
    since the line before (`since_last_s`: the phase's own seconds)."""
    now = time.perf_counter()
    since, _LAST_SAID[0] = now - _LAST_SAID[0], now
    print(f"[{phase}] " + json.dumps({**kw, "at_s": now - T_START, "since_last_s": since}),
          flush=True)


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


def _wrap_timer(obj, name, times):
    """Time each call of `obj.name` on a synchronized host clock, appending
    to `times`; `delattr(obj, name)` unwraps it."""
    import torch

    fn = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)


def _timed_rollouts(agent):
    """Time the rollout a learner's `train_epoch` runs (its graphed or eager
    one); returns (the list of times, a function that unwraps it)."""
    name = "_rollout_graphed" if agent.graphed else "_rollout_eager"
    times = []
    _wrap_timer(agent, name, times)
    return times, lambda: delattr(agent, name)


def _nothing() -> None:
    pass


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version, and its times
# ---------------------------------------------------------------------------

def _graph_ms(fn, iters: int = 50) -> float:
    """Device time of `fn` replayed from a CUDA graph (no host launch cost)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


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
    lr = torch.tensor(2e-5, device=dev)      # on the device, as the learner keeps it
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
        count_k = count.clone()
        scalar_err, counts = 0.0, []
        for step in range(K1_CHECK_STEPS):
            # global norm ~220 (clip active) on even steps, ~22 (no clip) on odd
            scale = 0.1 if step % 2 == 0 else 0.01
            grads = [torch.randn(p.shape, generator=gen, device=dev) * scale for p in leaves]
            scalars, count = FA.adam_scalars(grads, count, lr, 50.0)
            s_k, count_k = FA.global_norm_scalars(grads, count_k, lr, 50.0)
            scalar_err = max(scalar_err, float(((s_k - scalars).abs() / scalars.abs()).max()))
            counts.append((int(count_k), int(count)))
            # the update under the plain scalars: its arithmetic alone
            FA.update_leaves(pk, mk, vk, grads, scalars)
            for a in zip(pp, mp, vp, grads):
                FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
        err_p = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
        err_m = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(mk + vk, mp + vp))
        # both sides do the same f32 operations in the same order (the kernel
        # is built without FMA contraction; sqrt and division are IEEE-rounded
        # on both), so they agree to the last bit
        if not (err_p == 0.0 and err_m == 0.0):
            fail(f"K1 {tag} update disagrees with its plain version: p {err_p}, moments {err_m}")
        # the norm kernel sums in f64, the plain version in f32 trees
        scalar_tol = 1e-6
        if not scalar_err <= scalar_tol:
            fail(f"K1 {tag} norm scalars off by {scalar_err} relative")
        if any(a != b for a, b in counts):
            fail(f"K1 {tag} step counts {counts}")

        g = grads
        before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
        FA.fused_clip_adam_apply(pk, mk, vk, g, count_k, lr, 50.0)
        per_step = (FA.leaf_update.launches - before[0],
                    FA.global_norm_scalars.launches - before[1])
        if per_step != (1, 1):
            fail(f"K1 launched (update, norm) {per_step} times for one optimizer step")

        def step():
            FA.fused_clip_adam_apply(pk, mk, vk, g, count_k, lr, 50.0)

        def update():
            FA.update_leaves(pk, mk, vk, g, scalars)

        def norm():
            FA.global_norm_scalars(g, count_k, lr, 50.0)

        def plain_update():
            for a in zip(pp, mp, vp, g):
                FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)

        def plain_norm():
            FA.adam_scalars(g, count, lr, 50.0)

        def plain_step():
            s, _ = FA.adam_scalars(g, count, lr, 50.0)
            for a in zip(pp, mp, vp, g):
                FA._leaf_plain(*a, s, 0.9, 0.999, 1e-8)

        times = {}
        for name, fn in (("step", step), ("update", update), ("norm", norm),
                         ("plain_step", plain_step), ("plain_update", plain_update),
                         ("plain_norm", plain_norm)):
            times[name] = cuda_ms(fn, K1_TIMED_STEPS)
            times[name + "_graph"] = _graph_ms(fn, K1_TIMED_STEPS)
        # the wrapper's host cost alone: calls enqueued without a sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K1_TIMED_STEPS):
            step()
        host_ms = (time.perf_counter() - t0) / K1_TIMED_STEPS * 1e3
        torch.cuda.synchronize()
        FA.leaf_update.launches, FA.global_norm_scalars.launches = before

        ms_bytes = torch.finfo(mdt).bits // 8
        update_bytes = n_params * (4 + 4 + 4 + 2 * 2 * ms_bytes)   # p rw, g r, m v rw
        norm_bytes = n_params * 4                                   # g r
        flops = n_params * 15
        rows[tag] = dict(
            err_p=err_p, err_moments=err_m, scalar_rel_err=scalar_err, scalar_tol=scalar_tol,
            launches_per_step=per_step, host_ms_per_step=host_ms, **times,
            update_bound_ms=max(update_bytes / rate, flops / F32_FLOPS_PER_S) * 1e3,
            step_bound_ms=(update_bytes + norm_bytes) / rate * 1e3,
            norm_bound_ms=norm_bytes / rate * 1e3,
            update_bytes=update_bytes, norm_bytes=norm_bytes)

    # library yardstick: one fused Adam step over the same f32 leaves (no
    # clip scale, f32 moments), eager, and captured in a graph (capturable)
    lib = {}
    for capturable in (False, True):
        lp = [p.clone().requires_grad_(True) for p in leaves]
        for p in lp:
            p.grad = torch.randn(p.shape, generator=gen, device=dev) * 0.01
        opt = torch.optim.Adam(lp, lr=2e-5, eps=1e-8, fused=True, capturable=capturable)
        if capturable:
            lib["library_graph_ms"] = _graph_ms(opt.step, K1_TIMED_STEPS)
        else:
            lib["library_ms"] = cuda_ms(opt.step, K1_TIMED_STEPS)
    for tag, r in rows.items():
        r.update(lib)
        say("K1", moments=tag, card=card, n_params=n_params, leaves=16,
            library="torch.optim.Adam(fused=True).step(), f32 moments, no clip scale",
            hbm_bytes_per_s=rate, **r)
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
    FA.leaf_update.launches = FA.global_norm_scalars.launches = 0
    epoch_s, rows = [], []
    for _ in range(EPOCHS):
        t0 = time.perf_counter()
        ts, m = agent.train_epoch(ts)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in m.items()})
    launches = {"update": FA.leaf_update.launches, "norm": FA.global_norm_scalars.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # one norm and one update launch per optimizer step (up to 64 leaves)
    expected = EPOCHS * steps_per_epoch * -(-leaves // 64)
    if launches != {"update": expected, "norm": expected}:
        fail(f"K1 launched {launches} times on the main path, expected {expected} each")
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
        minibatch=MINIBATCH, mini_epochs=MINI_EPOCHS, epochs=EPOCHS,
        cut="8192 -> 4096 envs; 1 epoch",
        compute_dtype=str(agent.compute_dtype), n_params=sum(p.numel() for p in ts.params.values()),
        setup_s=setup_s, epoch_s=epoch_s, rollout_s=rollout_s,
        rollout_env_steps_per_s=NUM_ENVS * HORIZON / rollout_s,
        epoch_env_steps_per_s=NUM_ENVS * HORIZON / epoch_s[-1],
        optimizer_steps_per_epoch=steps_per_epoch, k1_launches=launches,
        peak_mem_gib=peak_gib, metrics=rows)
    return launches, agent, ts, lib


# ---------------------------------------------------------------------------
# phase 8: the epochs replayed from CUDA graphs against their eager bodies
# ---------------------------------------------------------------------------

GRAPH_MVAE_WINDOWS = 16          # one fuse=16 group


def _state_errs(a, b) -> dict:
    """Max abs differences between two imitation train states."""
    def err(x, y):
        return float((x.detach().float() - y.detach().float()).abs().max())

    return dict(params=max(err(a.params[k], b.params[k]) for k in a.params),
                mu=max(err(x, y) for x, y in zip(a.opt_state.mu, b.opt_state.mu)),
                nu=max(err(x, y) for x, y in zip(a.opt_state.nu, b.opt_state.nu)),
                count=int(a.opt_state.count) - int(b.opt_state.count),
                **{f"{n}_{f}": err(getattr(getattr(a, n), f), getattr(getattr(b, n), f))
                   for n in ("obs_norm", "val_norm") for f in ("n", "mean", "var")})


def _hold_epoch(what, a, ma, b, mb, steps, lr):
    """Graphed (a, ma) against eager (b, mb) on the same draws, held to
    tests/test_torch_epoch.py's bounds: metrics (and the value norm's
    elements) within its atol (1e-5 otherwise) and 1e-4 relative, params
    within 2·steps·lr, counts and the obs norm's count equal. The obs norm's
    mean and var are printed, also in units of its std and relative: they
    take every env's obs, and the envs that are done keep stepping, lying
    on the ground, where the contact sums' atomics put the last bits in
    another order from run to run (two eager epochs differ there too)."""
    errs = _state_errs(a, b)
    errs["metrics"] = {k: abs(float(ma[k]) - float(mb[k])) for k in ma}
    for k, e in errs["metrics"].items():
        if not e <= PARITY_ATOL.get(k, 1e-5) + 1e-4 * abs(float(mb[k])):
            fail(f"{what}: graphed and eager epochs disagree on {k}: {e}")
    if not errs["params"] <= 2 * steps * lr or errs["count"] or errs["obs_norm_n"]:
        fail(f"{what}: graphed and eager params differ by {errs['params']}, counts by "
             f"{errs['count']}, obs norm counts by {errs['obs_norm_n']}")
    for f in ("n", "mean", "var"):
        x, y = getattr(a.val_norm, f), getattr(b.val_norm, f)
        if not bool(((x - y).abs() <= 1e-5 + 1e-4 * y.abs()).all()):
            fail(f"{what}: graphed and eager val_norm.{f} differ by {errs[f'val_norm_{f}']}")
    std = b.obs_norm.var.sqrt() + 1e-8
    errs["obs_norm_mean_over_std"] = float(((a.obs_norm.mean - b.obs_norm.mean).abs()
                                            / std).max())
    errs["obs_norm_var_rel"] = float(((a.obs_norm.var - b.obs_norm.var).abs()
                                      / (b.obs_norm.var + 1e-12)).max())
    errs["bit_for_bit"] = all(v == 0 for k, v in errs.items() if k != "metrics") and \
        all(v == 0 for v in errs["metrics"].values())
    return errs


def _rollout_rows_differ(g, e) -> dict:
    """Where two rollouts from one state differ: the largest difference over
    the rows of envs still alive and over all rows, and the rows that
    differ."""
    import torch

    alive = e["alive"] > 0
    d = (g["obs"] - e["obs"]).abs().amax(-1)
    return dict(alive_equal=torch.equal(g["alive"], e["alive"]),
                max_abs_err_alive_rows=float(d[alive].max()) if bool(alive.any()) else 0.0,
                max_abs_err_all_rows=float(d.max()), rows_differ=int((d > 0).sum()),
                alive_rows_differ=int(((d > 0) & alive).sum()))


def _graph_stats(g) -> dict:
    return dict(nodes=g.nodes, capture_s=g.capture_s, instantiate_s=g.instantiate_s,
                pool_gib=g.pool_bytes / 2 ** 30, captures=g.captures,
                launches_per_replay=list(g.launches))


def graphs_phase(dev, card: str):
    """The imitation epoch and the MotionVAE windows replayed from CUDA
    graphs (`utils/graphs.py`), each against its eager body on the same
    draws: the small imitation case and main's config at 4096 envs (each
    from two fresh states of one seed: the same generator draws), the
    rollout alone graphed and twice eager (the card's own spread),
    mvae_federer at full width (fuse=16, fuse=1 and the eager windows). Times, the graphs'
    capture and instantiate seconds, node counts and pools, K1's and K2's
    launches through the replays, the device's idle share over one graphed
    epoch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset
    from vid2player3d_torch.ops import fused_adam as FA
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    cases = (("small", 4, 4, 8, 2, 2, 60, "f32"),
             ("main", NUM_ENVS, HORIZON, MINIBATCH, MINI_EPOCHS, 8, 300, "auto"))
    for name, n, t, mb, me, motions, frames, dtype in cases:
        lib = make_synthetic_motion_lib(num_motions=motions, T=frames, fps=30.0, seed=0,
                                        device=dev)
        env = HumanoidImEnv(HumanoidImConfig(num_envs=n, substeps=SUBSTEPS), lib, rng=0,
                            device=dev)
        agent = ImitationPPO(env, PPOConfig(horizon=t, minibatch_size=mb, mini_epochs=me,
                                            fused_optimizer="on", compute_dtype=dtype),
                             seed=7, device=dev)
        if not agent.graphed:
            fail(f"graphs: the {name} imitation learner does not take the graphs")
        steps = agent.num_minibatches * me
        roll = {"graphed": [], "eager": []}
        _wrap_timer(agent, "_rollout_graphed", roll["graphed"])
        _wrap_timer(agent, "_rollout_eager", roll["eager"])
        r = {"envs": n, "horizon": t, "optimizer_steps": steps}

        def epoch(mode, fn, ts):
            """One epoch, timed, K1 counted from 0."""
            FA.leaf_update.launches = FA.global_norm_scalars.launches = 0
            del roll[mode][:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = fn(ts)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            k1 = [FA.leaf_update.launches, FA.global_norm_scalars.launches]
            if k1 != [steps, steps]:
                fail(f"graphs {name}: K1 launched {k1} in a {mode} epoch, expected {steps} each")
            return ts, m, dict(epoch_s=epoch_s, rollout_s=roll[mode][0],
                               optimizer_step_ms=(epoch_s - roll[mode][0]) / steps * 1e3,
                               k1_launches=k1)

        # the first graphed call captures both graphs; then one eager epoch
        # on the same draws
        a, ma, first = epoch("graphed", agent.train_epoch, agent.init_state())
        b, mb_, eager = epoch("eager", agent._train_epoch_eager, agent.init_state())
        r["vs_eager"] = _hold_epoch(f"graphs {name}", a, ma, b, mb_, steps,
                                    agent.cfg.learning_rate)
        _, _, graphed = epoch("graphed", agent.train_epoch, a)       # replays only
        r["times"] = timed = {"graphed": graphed, "eager": eager, "graphed_first_call": first}
        # the rollout alone, graphed and twice eager (the card's own spread),
        # each from the state after the first epoch with the generator
        # seeded anew (the same draws)
        trajs = []
        for mode, fn in (("graphed", agent.rollout), ("eager", agent._rollout_eager),
                         ("eager", agent._rollout_eager)):
            del roll[mode][:]
            trajs.append(fn(dataclasses.replace(
                a, generator=torch.Generator(dev).manual_seed(agent.seed))))
            timed[mode]["rollout_alone_s"] = roll[mode][0]
        r["rollout_vs_eager"] = _rollout_rows_differ(trajs[0], trajs[1])
        r["rollout_eager_vs_eager"] = _rollout_rows_differ(trajs[2], trajs[1])
        del trajs
        r["epoch_speedup"] = timed["eager"]["epoch_s"] / timed["graphed"]["epoch_s"]
        r["graphs"] = {g: _graph_stats(getattr(agent._st, g)) for g in ("step", "update")}
        if name == "main":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                agent.train_epoch(a)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            # ~670 k device events: read from the raw results, not as
            # FunctionEvents (~50 s)
            t0 = time.perf_counter()
            evs = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
            busy = sum(e.duration_ns() for e in evs) * 1e-9
            r["profile"] = dict(wall_s=wall, device_busy_s=busy if evs else "not measured",
                                device_idle_share=(1.0 - busy / wall) if evs else "not measured",
                                device_events=len(evs), read_s=time.perf_counter() - t0)
        if not all(np.isfinite(float(v)) for v in ma.values()):
            fail(f"graphs {name}: non-finite metrics {ma}")
        out[name] = r
        del agent, env, lib, a, b
        torch.cuda.empty_cache()

    opt = MVAEOption.load("federer")
    nsteps = opt.nframes_seq - opt.num_future_predictions - opt.num_condition_frames + 1
    steps = GRAPH_MVAE_WINDOWS * nsteps
    runs, mvae = {}, {}
    for mode in ("eager", 16, 1):
        trainer = MVAETrainer(opt, make_synthetic_pose_dataset(opt, num_seqs=64, T=300, seed=0),
                              device=dev)
        trainer.epoch = MVAE_START_EPOCH
        MOE.moe_linear.launches = MOE.split_weights.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = (trainer._train_epoch_eager(GRAPH_MVAE_WINDOWS) if mode == "eager" else
                  trainer.train_epoch(batches_per_epoch=GRAPH_MVAE_WINDOWS, fuse=mode))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        k2 = [MOE.moe_linear.launches, MOE.split_weights.launches]
        if k2 != [3 * steps, 3 * steps]:
            fail(f"graphs: K2 launched {k2} in {steps} MotionVAE steps ({mode})")
        t0 = time.perf_counter()
        trainer.train_epoch(batches_per_epoch=GRAPH_MVAE_WINDOWS, fuse=mode) \
            if mode != "eager" else trainer._train_epoch_eager(GRAPH_MVAE_WINDOWS)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        runs[mode] = (losses, [p.detach().clone() for p in trainer.params])
        mvae[f"fuse_{mode}" if mode != "eager" else "eager"] = dict(
            first_epoch_s=first_s, epoch_s=again_s, ms_per_optimizer_step=again_s / steps * 1e3,
            k2_launches=k2, losses=losses,
            graph=_graph_stats(trainer._graph.window) if mode != "eager" else None)
    for mode in (16, 1):
        err = max(float((x - y).abs().max()) for x, y in zip(runs[mode][1], runs["eager"][1]))
        mvae[f"fuse_{mode}"]["params_max_abs_err_vs_eager"] = err
        if runs[mode][0] != runs["eager"][0] or err != 0.0:
            fail(f"graphs: MotionVAE fuse={mode} differs from the eager windows: {err}, "
                 f"{runs[mode][0]} vs {runs['eager'][0]}")
    mvae["windows"], mvae["optimizer_steps"] = GRAPH_MVAE_WINDOWS, steps
    mvae["step_speedup"] = mvae["eager"]["epoch_s"] / mvae["fuse_16"]["epoch_s"]
    say("graphs", card=card, nvidia_smi=nvidia_smi(), torch=torch.__version__,
        register_generator_state=hasattr(torch.cuda.CUDAGraph, "register_generator_state"),
        imitation=out, mvae_federer=mvae, phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# phase 6: where the time goes (torch.profiler over a short epoch)
# ---------------------------------------------------------------------------

def _device_events(prof):
    """The device kernels and copies of a profile; the device-side ranges of
    `record_function` spans are left out (they are not device work)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in SPANS]


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
    epoch_rollout_s, unwrap = _timed_rollouts(agent)
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
    unwrap()
    steps = agent.num_minibatches
    r, e = out["rollout"], out["epoch"]
    say("profile", card=card, envs=NUM_ENVS, horizon=horizon, optimizer_steps=steps,
        device_events_per_env_step=r["device_events"] / horizon,
        device_events_per_optimizer_step=(e["device_events"] - r["device_events"]) / steps,
        update_wall_s_per_optimizer_step=(e["wall_s"] - epoch_rollout_s[-1]) / steps,
        rollout_wall_s_per_env_step=r["wall_s"] / horizon, **out)


# ---------------------------------------------------------------------------
# phase 4: K2 against its plain version, and its times
# ---------------------------------------------------------------------------

MOE_LAYERS = ((320, 256), (288, 256), (288, 290))   # the decoder at full width
MOE_EXPERTS = 6
TENNIS_ENVS, TENNIS_HORIZON, TENNIS_MINIBATCH, TENNIS_MINI_EPOCHS = 10240, 64, 16384, 6
# `tennis_main`: the first epoch captures the graphs, the second replays
# them; `tennis_dr_main` runs SLICE4_EPOCHS
TENNIS_EPOCHS = 2
STAGE2_ENVS, STAGE2_STEPS = 15360, 8
# `dual_main`: the first epoch captures the graphs, the second replays them
DUAL_ENVS, DUAL_HORIZON, DUAL_MINIBATCH, DUAL_MINI_EPOCHS, DUAL_EPOCHS = 15360, 32, 16384, 6, 2
LANE_DECODE = DUAL_ENVS // 2    # the dual rally decodes each lane's rows on their own
MVAE_BATCH = 100                # mvae_federer's batch: the trainer's decodes
KERNEL_TIMED = 50


def _moe_layer_inputs(dev, batch, d_in, d_out, gen):
    import torch

    x = torch.randn(batch, d_in, generator=gen, device=dev)
    coeff = torch.softmax(torch.randn(batch, MOE_EXPERTS, generator=gen, device=dev), -1)
    lim = (6.0 / (MOE_EXPERTS * d_in)) ** 0.5          # the decoder's he-uniform init
    w = (torch.rand(MOE_EXPERTS, d_in, d_out, generator=gen, device=dev) * 2 - 1) * lim
    b = torch.randn(MOE_EXPERTS, d_out, generator=gen, device=dev) * 0.1
    return x, coeff, w, b


def _k2_times(dev, card: str, batch: int, gen, layers=None):
    """One decode's three layers at `batch` rows (`layers`, else fresh
    inputs): the kernels, their plain versions and the cuBLAS yardstick,
    eager and as graphs, beside the bounds."""
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    if layers is None:
        layers = [_moe_layer_inputs(dev, batch, d_in, d_out, gen) for d_in, d_out in MOE_LAYERS]
    # the library yardstick: x @ W reshaped to (in, 6*out), one cuBLAS GEMM
    # per layer with the same FLOPs and no blend
    wide = [(x, w.permute(1, 0, 2).reshape(w.shape[1], -1).contiguous()) for x, _, w, _ in layers]
    fns = {
        "decode": lambda: [MOE.moe_linear(*a) for a in layers],
        "plain": lambda: [MOE.moe_linear_ref(*a) for a in layers],
        "library": lambda: [x @ w2 for x, w2 in wide],
        "split": lambda: [MOE.split_weights(a[2], a[3]) for a in layers],
        "plain_split": lambda: [MOE._split_plain(a[2], a[3], MOE.padded_in(a[2].shape[1],
                                                                           MOE_EXPERTS))
                                for a in layers],
    }
    before = (MOE.moe_linear.launches, MOE.split_weights.launches)
    times = {}
    for name, fn in fns.items():
        times[name + "_ms"] = cuda_ms(fn, KERNEL_TIMED)
        times[name + "_graph_ms"] = _graph_ms(fn, KERNEL_TIMED)
    # timing launches are not the main path's
    MOE.moe_linear.launches, MOE.split_weights.launches = before
    flops = sum(2 * MOE_EXPERTS * batch * i * o for i, o in MOE_LAYERS)
    nbytes = 4 * sum(batch * i + batch * MOE_EXPERTS + MOE_EXPERTS * i * o
                     + MOE_EXPERTS * o + batch * o for i, o in MOE_LAYERS)
    # W and bias read, hi and lo written
    split_bytes = 4 * 3 * sum(MOE_EXPERTS * (i + 1) * o for i, o in MOE_LAYERS)
    rate = hbm_rate(card)
    tf32_bound_ms = max(nbytes / rate, 3 * flops / TF32_FLOPS_PER_S) * 1e3
    f32_bound_ms = max(nbytes / rate, flops / F32_FLOPS_PER_S) * 1e3
    graph_ms = times["decode_graph_ms"]
    return dict(ms=times["decode_ms"], graph_ms=graph_ms,
                plain_ms=times["plain_ms"], plain_graph_ms=times["plain_graph_ms"],
                library_ms=times["library_ms"], library_graph_ms=times["library_graph_ms"],
                split_ms=times["split_ms"], split_graph_ms=times["split_graph_ms"],
                plain_split_ms=times["plain_split_ms"],
                plain_split_graph_ms=times["plain_split_graph_ms"],
                bound_ms=tf32_bound_ms, f32_simt_bound_ms=f32_bound_ms,
                split_bound_ms=split_bytes / rate * 1e3, flops=flops, bytes=nbytes,
                split_bytes=split_bytes,
                bound_by="operations" if 3 * flops / TF32_FLOPS_PER_S >= nbytes / rate
                else "bytes",
                achieved_tflops=flops / (graph_ms * 1e-3) / 1e12,
                issued_tf32_tflops=3 * flops / (graph_ms * 1e-3) / 1e12,
                share_of_3xtf32_bound=tf32_bound_ms / graph_ms,
                share_of_f32_simt_bound=f32_bound_ms / graph_ms)


def _k2_backward_err(MOE, leaves, g):
    """The largest gap between K2's autograd.Function gradients and autograd
    of the plain forward on the same leaves; fails beyond 1e-3 relative."""
    import torch

    lk = [t.clone().requires_grad_(True) for t in leaves]
    lp = [t.clone().requires_grad_(True) for t in leaves]
    gk = torch.autograd.grad(MOE.moe_linear(*lk), lk, g)
    gp = torch.autograd.grad(MOE.moe_linear_ref(*lp), lp, g)
    err = 0.0
    for a, c in zip(gk, gp):
        e = float((a - c).abs().max())
        err = max(err, e)
        if not e <= 1e-3 * max(1.0, float(c.abs().max())):
            fail(f"K2 backward disagrees with autograd at B={g.shape[0]} "
                 f"{leaves[0].shape[1]}x{g.shape[1]}: {e}")
    return err


def k2_phase(dev, card: str):
    import torch

    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    gen = torch.Generator(device=dev).manual_seed(3)
    # 3xTF32 keeps f32-grade products; the tensor cores' f32 sums and the
    # plain version's (cuBLAS, blend after the product) differ by rounding
    tol = 1e-4
    errs = {}
    for batch in (STAGE2_ENVS, TENNIS_ENVS, LANE_DECODE, 1001, 255, MVAE_BATCH, 1):
        for d_in, d_out in MOE_LAYERS:
            x, coeff, w, b = _moe_layer_inputs(dev, batch, d_in, d_out, gen)
            got = MOE.moe_linear(x, coeff, w, b)
            want = MOE.moe_linear_ref(x, coeff, w, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            errs[f"B{batch}_{d_in}x{d_out}"] = err
            if not err <= tol * max(1.0, scale):
                fail(f"K2 disagrees with its plain version at B={batch} {d_in}x{d_out}: {err}")
    # the prep kernel against its plain version: the same rounding, bit for bit
    split_err = 0.0
    for d_in, d_out in MOE_LAYERS:
        _, _, w, b = _moe_layer_inputs(dev, 1, d_in, d_out, gen)
        got = MOE.split_weights(w, b)
        want = MOE._split_plain(w, b, MOE.padded_in(d_in, MOE_EXPERTS))
        split_err = max([split_err] + [float((a - c).abs().max()) for a, c in zip(got, want)])
    if split_err != 0.0:
        fail(f"K2's prep kernel disagrees with its plain version: {split_err}")
    # the autograd.Function's backward against autograd of the plain forward
    bwd_err = max(_k2_backward_err(MOE, _moe_layer_inputs(dev, batch, d_in, d_out, gen),
                                   torch.randn(batch, d_out, generator=gen, device=dev))
                  for batch in (256, MVAE_BATCH) for d_in, d_out in MOE_LAYERS)
    tilings = {f"out{o}": MOE.tiling(o) for o in sorted({o for _, o in MOE_LAYERS})}
    for t in tilings.values():
        if t["ctas_per_sm"] < 1:
            fail(f"K2's tiling does not fit an SM: {t}")

    times = {batch: _k2_times(dev, card, batch, gen)
             for batch in (TENNIS_ENVS, LANE_DECODE, STAGE2_ENVS)}
    main = times[TENNIS_ENVS]
    keys = ("ms", "graph_ms", "plain_ms", "plain_graph_ms", "library_ms", "library_graph_ms",
            "bound_ms", "bound_by", "f32_simt_bound_ms", "share_of_3xtf32_bound",
            "achieved_tflops", "flops")
    row = dict(main, max_abs_err=max(errs.values()), tol=tol, split_max_abs_err=split_err,
               backward_max_abs_err=bwd_err,
               per_lane_B7680={k: times[LANE_DECODE][k] for k in keys},
               stage2_B15360={k: times[STAGE2_ENVS][k] for k in keys})
    say("K2", card=card, unit="one MVAE decode at B=10240 (per_lane_B7680: one lane of the "
        "dual rally; stage2_B15360: the stage-2 decode): 3 prep + 3 GEMM launches", errs=errs,
        library="x @ W.reshape(in, 6*out): one cuBLAS f32 GEMM per layer, same FLOPs, "
                "no blend",
        tiling=tilings, **row)
    return row


# ---------------------------------------------------------------------------
# phase 5: K3 against its plain version, and its times
# ---------------------------------------------------------------------------

# the stage-1, stage-2 (and dual) and two-hand single-player steps, the candidates
K3_TIMED_NS = (TENNIS_ENVS, STAGE2_ENVS, 30720, 256)
K3_COLD_BYTES = 200e6     # a cold rotation's inputs and outputs: 4x the 50 MB L2
K3_TIMED = 200


def k3_phase(dev, card: str):
    import math

    import torch

    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.ops import fk as FK
    from vid2player3d_torch.physics.asset import mujoco_parents

    trees = {"mujoco": tuple(int(p) for p in mujoco_parents()),
             "smpl": tuple(int(p) for p in S.SMPL_PARENTS)}
    parents = trees["mujoco"]
    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(n):
        rot = torch.eye(3, device=dev).expand(n, 24, 3, 3) \
            + 0.05 * torch.randn(n, 24, 3, 3, generator=gen, device=dev)
        return (rot.contiguous(), torch.randn(n, 24, 3, generator=gen, device=dev) * 0.1,
                torch.randn(n, 3, generator=gen, device=dev))

    def offset_view(t, floats=1):
        """`t` as a contiguous view 4 bytes past a 16-byte boundary."""
        view = torch.empty(t.numel() + floats, device=dev)[floats:].view(t.shape)
        return view.copy_(t)

    cases = [(f"mujoco_N{n}", trees["mujoco"], inputs(n))
             for n in (1, 255, 256, 257, TENNIS_ENVS, STAGE2_ENVS, 30720)]
    cases.append((f"smpl_N{TENNIS_ENVS}", trees["smpl"], inputs(TENNIS_ENVS)))
    cases.append(("mujoco_N257_offset_4B", trees["mujoco"], [offset_view(t) for t in inputs(257)]))
    errs = {}
    before = FK.fk_chain.launches
    for name, tree, args in cases:
        pos, rm = FK.fk_chain(*args, tree)
        wpos, wrm = FK._fk_plain(*args, tree)
        torch.cuda.synchronize()
        errs[name] = max(float((pos - wpos).abs().max()), float((rm - wrm).abs().max()))
    if FK.fk_chain.launches - before != len(cases):
        fail(f"K3 launched {FK.fk_chain.launches - before} times for {len(cases)} calls")
    del cases
    # same products and sums in the same order, no FMA: bit for bit
    tol = 0.0
    if max(errs.values()) > tol:
        fail(f"K3 disagrees with its plain version: {errs}")
    # the tennis path's tree takes the kernel's straight-line MuJoCo build
    builds = {name: FK.kernel_tree(tree) for name, tree in trees.items()}
    if builds != {"mujoco": 1, "smpl": 0}:
        fail(f"K3 builds of the humanoid trees: {builds}")

    rate = hbm_rate(card)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_env = 24 * 9 + 24 * 3 + 3 + 24 * 3 + 24 * 9      # floats read + written
    per_n = {}
    for n in K3_TIMED_NS:
        nbytes = 4 * per_env * n
        flops = n * 23 * (9 * 5 + 3 * 6)                  # 3x3 @ 3x3 and 3x3 @ 3 + add
        # cold: input sets taken in turn, each call writing fresh outputs,
        # together 4x the L2, so every call reads and writes device memory
        sets = max(4, math.ceil(K3_COLD_BYTES / nbytes))
        ins = [inputs(n) for _ in range(sets)]
        outs = [None] * sets
        turn = [0]

        def cold():
            k = turn[0] % sets
            turn[0] += 1
            outs[k] = FK.fk_chain(*ins[k], parents)

        def warm():
            FK.fk_chain(*ins[0], parents)

        calls = sets * math.ceil(K3_TIMED / sets)
        row = dict(
            launch_shape=FK.launch_shape(n, 24, sms), cold_sets=sets, cold_bytes=sets * nbytes,
            warm_ms=cuda_ms(warm, K3_TIMED), warm_graph_ms=_graph_ms(warm, K3_TIMED),
            ms=cuda_ms(cold, calls),
            graph_ms=_graph_ms(lambda: [FK.fk_chain(*a, parents) for a in ins],
                               math.ceil(K3_TIMED / sets)) / sets,
            bound_ms=max(nbytes / rate, flops / F32_FLOPS_PER_S) * 1e3, bytes=nbytes,
            flops=flops,
            bound_by="bytes" if nbytes / rate >= flops / F32_FLOPS_PER_S else "operations")
        # the wrapper's host cost alone: calls enqueued without a sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K3_TIMED):
            warm()
        row["host_ms_per_call"] = (time.perf_counter() - t0) / K3_TIMED * 1e3
        torch.cuda.synchronize()
        row["share_of_bound"] = row["bound_ms"] / row["graph_ms"]
        # a cold time under the bound would mean the rotation stayed in L2
        row["cold_under_bound"] = row["graph_ms"] < row["bound_ms"]
        if n == TENNIS_ENVS:
            row["plain_ms"] = cuda_ms(lambda: FK._fk_plain(*ins[0], parents), KERNEL_TIMED)
            row["plain_graph_ms"] = _graph_ms(lambda: FK._fk_plain(*ins[0], parents))
        per_n[f"N{n}"] = row
        del ins, outs
    # timing launches are not the main path's
    FK.fk_chain.launches = before
    row = dict(per_n[f"N{TENNIS_ENVS}"], max_abs_err=max(errs.values()), tol=tol,
               library_ms=None, **{f"N{n}": {k: per_n[f"N{n}"][k] for k in (
                   "ms", "graph_ms", "warm_ms", "warm_graph_ms", "bound_ms", "share_of_bound")}
                   for n in (STAGE2_ENVS, 30720)})
    say("K3", card=card, unit="one FK of N envs, 24 joints; ms / graph_ms cold (input and "
        "output sets over 4x the L2 taken in turn), warm_* one set again and again",
        errs=errs, builds=builds, library="none: no single PyTorch call computes FK",
        per_n=per_n)
    return row


# ---------------------------------------------------------------------------
# the tennis path's pieces
# ---------------------------------------------------------------------------

def _init_frames(seed: int = 0):
    """64 synthetic MVAE init frames, as the CLI makes them without a trained
    MVAE (x0.05, root height 0.95; the CLI seeds player b's with seed + 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ft = (rng.standard_normal((64, 288)) * 0.05).astype(np.float32)
    ft[:, 2] = 0.95
    return ft


def _tennis_env(dev, env_cfg, hidden, experts, gen=None, pi_low=None):
    """Random MVAE spec + random full-width pi_low (seed 0; or `pi_low`) ->
    TennisEnv on `dev`."""
    import torch

    from vid2player3d_torch.envs import TennisEnv
    from vid2player3d_torch.learn import FrozenImitator
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    spec = P.make_random_spec(0, hidden=hidden, experts=experts, device=dev)
    if pi_low is None:
        net = ImitatorNet(num_actions=75, generator=torch.Generator().manual_seed(0)).to(dev)
        pi_low = FrozenImitator(net=net, obs_norm=RN.RunningNormState.create(734, dev))
    if gen is None:
        gen = TennisBallGenerator(num_candidates=4096, seed=0, device=dev)
    return TennisEnv(env_cfg, spec, _init_frames(), ball_generator=gen, pi_low=pi_low,
                     device=dev)


def _dual_env(dev, env_cfg, hidden, experts, gen=None):
    """The nadal_federer pairing on `dev`: lane 0 a left-handed nadal MVAE
    (seed 0) with the two-hand backhand, lane 1 a federer MVAE (seed 1), each
    with its own 64 init frames and random full-width pi_low (seeds 0, 1)
    -> DualTennisEnv."""
    import dataclasses

    import torch

    from vid2player3d_torch.envs import DualTennisEnv
    from vid2player3d_torch.learn import FrozenImitator
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    specs = (dataclasses.replace(P.make_random_spec(0, player="nadal", hidden=hidden,
                                                    experts=experts, device=dev),
                                 righthand=False),
             P.make_random_spec(1, player="federer", hidden=hidden, experts=experts, device=dev))
    pi_low = [FrozenImitator(net=ImitatorNet(num_actions=75,
                                             generator=torch.Generator().manual_seed(s)).to(dev),
                             obs_norm=RN.RunningNormState.create(734, dev)) for s in (0, 1)]
    if gen is None:
        gen = TennisBallGenerator(num_candidates=4096, seed=0, device=dev)
    return DualTennisEnv(env_cfg, specs, (_init_frames(0), _init_frames(1)), ball_generator=gen,
                         pi_low=pi_low[0], pi_low_b=pi_low[1], two_hand_lanes=(True, False),
                         device=dev)


def _tennis_draws(rng, n, horizon, mini_epochs, pool, k, num_actions, n_init=64, dual=False):
    """Explicit draws for a tennis epoch (discrete targets; with `dual`,
    continuous targets and the serve's uniforms), so two devices run the
    same epoch."""
    import numpy as np

    def target(m):
        return rng.random((m, 3)) if dual else rng.random(m)

    def reset(m):
        d = {"init_idx": rng.integers(0, n_init, m), "root_xy_u": rng.random((m, 2)),
             "ball_idx": rng.integers(0, pool, m), "target_u": target(m),
             "tt": rng.integers(-5, 5, m)}
        if dual:
            d["serve_u"] = rng.random((m, 3))
        return d

    win = max(1, pool // 8)
    env = [dict(reset=reset(k if 0 < k < n else n), rw_noise=rng.standard_normal((n, 32)),
                ball_idx=rng.integers(0, pool, n),
                near_jitter=rng.integers(-win // 2, win // 2 + 1, n),
                target_u=target(n), tt=rng.integers(-5, 5, n))
           for _ in range(horizon)]
    return reset(n), {"noise": rng.standard_normal((horizon, n, num_actions)).astype(np.float32),
                 "perms": np.stack([rng.permutation(n * horizon) for _ in range(mini_epochs)]),
                 "env": env}


# ---------------------------------------------------------------------------
# phase 8: a small tennis epoch on the card against the CPU
# ---------------------------------------------------------------------------

def tennis_parity_phase(dev):
    import numpy as np

    from vid2player3d_torch.envs import TennisConfig
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    n, t, mb, me = 4, 4, 8, 2
    env_cfg = TennisConfig(num_envs=n, substeps=2, max_episode_length=40,
                           reset_reaction_nframes=6, reward_type="reach",
                           use_random_ball_target="discrete", reset_candidates=2)
    v2p_cfg = V2PConfig(horizon=t, minibatch_size=mb, mini_epochs=me, actor_units=(64, 32),
                        critic_units=(64, 32), compute_dtype="f32", lr_schedule="adaptive")
    pool = TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    reset_draws, draws = _tennis_draws(np.random.default_rng(0), n, t, me, pool.pool_size, 2,
                                       35, n_init=64)
    metrics = {}
    for d in ("cpu", dev):
        gen = TennisBallGenerator.from_arrays(pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                              pool.launch_vspin, device=d)
        agent = V2PPPO(_tennis_env(d, env_cfg, hidden=64, experts=3, gen=gen), v2p_cfg,
                       seed=7, device=d)
        ts = agent.init_state(reset_draws=reset_draws)
        _, m = agent.train_epoch(ts, draws=draws)
        metrics[str(d)] = {k: float(v) for k, v in m.items()}
    ref, got = metrics["cpu"], metrics[str(dev)]
    worst = {}
    for k in ref:
        err = abs(got[k] - ref[k])
        worst[k] = err
        if not err <= PARITY_ATOL.get(k, 1e-5) + 1e-4 * abs(ref[k]):
            fail(f"card and CPU tennis epochs disagree on {k}: {got[k]} vs {ref[k]}")
    say("tennis_parity", envs=n, horizon=t, metric_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 9: the tennis main path
# ---------------------------------------------------------------------------

def _snapshot(agent, ts):
    """A function giving fresh copies of a train state (tennis or
    imitation), each with the learner's and (tennis) the env's generators
    set back to where they stood, so that every epoch from a copy takes the
    same draws."""
    import dataclasses

    import torch

    from vid2player3d_torch.learn.optim import AdamState
    from vid2player3d_torch.parallel import mesh as PM

    saved = PM.tree_map(lambda t: t.detach().clone(), dataclasses.replace(ts, generator=None))
    gen_state = ts.generator.get_state()
    env_gen = getattr(agent.env, "generator", None)
    env_gen = None if env_gen is None else env_gen.get_state()

    def fresh():
        if env_gen is not None:
            agent.env.generator.set_state(env_gen)
        gen = torch.Generator(ts.generator.device)
        gen.set_state(gen_state)
        c = PM.tree_map(torch.clone, saved)
        return dataclasses.replace(
            c, generator=gen,
            params={k: v.requires_grad_(True) for k, v in c.params.items()},
            opt_state=AdamState(c.opt_state.count, c.opt_state.mu, c.opt_state.nu))

    return fresh


def _stage1_agent(dev, n, gen=None, horizon=None, minibatch=None, mini_epochs=None,
                  episode=600, reaction=70, candidates=256, pi_low=None):
    """federer_train_stage_1's learner at `n` envs (its sizes unless given):
    random full-width MVAE and pi_low from seed 0 (or `pi_low`), reach
    reward, discrete targets."""
    from vid2player3d_torch.envs import TennisConfig
    from vid2player3d_torch.learn import V2PConfig, V2PPPO

    horizon = horizon or TENNIS_HORIZON
    minibatch = minibatch or TENNIS_MINIBATCH
    mini_epochs = mini_epochs or TENNIS_MINI_EPOCHS

    env_cfg = TennisConfig(num_envs=n, substeps=2, max_episode_length=episode,
                           reward_type="reach", use_random_ball_target="discrete",
                           reset_reaction_nframes=reaction, reset_candidates=candidates)
    env = _tennis_env(dev, env_cfg, hidden=256, experts=6, gen=gen, pi_low=pi_low)
    return V2PPPO(env, V2PConfig(
        horizon=horizon, minibatch_size=minibatch, mini_epochs=mini_epochs, learning_rate=1e-4,
        sigma_init=-0.69, bounds_loss_coef=10.0, critic_coef=5.0, grad_norm=50.0), seed=7,
        device=dev)


def tennis_main_phase(dev, card: str):
    """federer_train_stage_1 at its sizes, graphed: the first epoch captures
    the step and update graphs, the second replays them. K2 and K3 counted
    through the replays, per epoch. Returns the learner, its state and the
    launches of one epoch."""
    import torch

    t0 = time.perf_counter()
    agent = _stage1_agent(dev, TENNIS_ENVS)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps_per_epoch = agent.num_minibatches * TENNIS_MINI_EPOCHS
    want = {"moe_linear": 3 * TENNIS_HORIZON, "moe_split_w": 3 * TENNIS_HORIZON,
            "fk_chain": 2 * TENNIS_HORIZON}
    # the rollout (policy forward + env step) is timed inside the epoch, for
    # env-steps/s
    ts, epoch_s, rollout_times, rows, launches, graphs, peak_gib = _graphed_epochs(
        "tennis_main", agent, ts, TENNIS_EPOCHS, want)

    keep = ("hit_rate", "contact_rate", "racket_ball_dist", "racket_ball_dist_p90", "cycles",
            "done_rate", "reward_mean", "c_loss", "kl", "grad_skip")
    say("tennis_main", card=card, nvidia_smi=nvidia_smi(), envs=TENNIS_ENVS,
        horizon=TENNIS_HORIZON, substeps=2, minibatch=TENNIS_MINIBATCH,
        mini_epochs=TENNIS_MINI_EPOCHS, epochs=TENNIS_EPOCHS, graphed=agent.graphed,
        note="epoch 0 captures both graphs, epoch 1 replays them",
        compute_dtype=str(agent.compute_dtype), mvae="hidden 256, 6 experts, 288->290",
        ball_pool=agent.env.gen.pool_size, setup_s=setup_s, epoch_s=epoch_s,
        rollout_s=rollout_times,
        rollout_env_steps_per_s=TENNIS_ENVS * TENNIS_HORIZON / rollout_times[-1],
        epoch_env_steps_per_s=TENNIS_ENVS * TENNIS_HORIZON / epoch_s[-1],
        optimizer_steps_per_epoch=steps_per_epoch,
        optimizer_step_ms=[(e - r) / steps_per_epoch * 1e3
                           for e, r in zip(epoch_s, rollout_times)],
        launches_per_epoch=launches, graphs=graphs, peak_mem_gib=peak_gib,
        metrics=[{k: r[k] for k in keep} for r in rows])
    one = {k: launches[-1][k] for k in ("moe_linear", "moe_split_w", "fk_chain")}
    return agent, ts, one


# ---------------------------------------------------------------------------
# phase 10b: the tennis epochs replayed from CUDA graphs against eager ones
# ---------------------------------------------------------------------------

GRAPH_TENNIS_SMALL = 8                # envs of the bit-for-bit case
# the deterministic comparison at 10,240 envs: horizon cut from 64 (60
# optimizer steps) to 16, then to 8 to keep the script inside its time
# limit, as its eager epoch takes ~2x the default mode's time
DET_HORIZON = 8
STAGE2_HORIZON, STAGE2_MINIBATCH = 32, 16384   # federer_train_stage_2's learner


def _differ(a, ma, b, mb) -> dict:
    """What differs between two train states (tennis or imitation) and their
    metrics: each quantity's largest absolute difference, where it is not
    0."""
    import math

    from vid2player3d_torch.parallel import mesh as PM

    def err(x, y):
        return float((x.detach().float() - y.detach().float()).abs().max())

    def metric(k):
        x, y = float(ma[k]), float(mb[k])
        return 0.0 if (x == y or (math.isnan(x) and math.isnan(y))) else abs(x - y)

    gaps = dict(params=max(err(a.params[k], b.params[k]) for k in a.params),
                mu=max(err(x, y) for x, y in zip(a.opt_state.mu, b.opt_state.mu)),
                nu=max(err(x, y) for x, y in zip(a.opt_state.nu, b.opt_state.nu)),
                count=int(a.opt_state.count) - int(b.opt_state.count),
                **({} if not hasattr(a, "env_state") else dict(
                    env_state=max(err(x, y) for x, y in zip(PM.tree_leaves(a.env_state),
                                                            PM.tree_leaves(b.env_state))),
                    last_obs=err(a.last_obs, b.last_obs))),
                **{f"{n}_{f}": err(getattr(getattr(a, n), f), getattr(getattr(b, n), f))
                   for n in ("obs_norm", "val_norm") for f in ("n", "mean", "var")},
                **{"metric_" + k: metric(k) for k in ma})
    return {k: v for k, v in gaps.items() if v}


def _timed_epoch(fn, ts):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, m = fn(ts)
    torch.cuda.synchronize()
    return ts, m, time.perf_counter() - t0


def tennis_graphs_phase(dev, card: str, agent, ts, stage2_env):
    """The tennis epoch replayed from CUDA graphs against the eager epoch.
    The contact sums' `index_add` atomics make two eager epochs differ on
    the card (the phase prints what differs at 8 envs: two eager epochs and
    a graphed one from one state and draws), so graphed and eager are held
    bit for bit under `torch.use_deterministic_algorithms`, where two eager
    epochs agree (each learner captured in that mode): stage 1 at 8 envs
    over two epochs and at 10,240 envs over one (horizon 16). Then one graphed stage-2
    epoch at 15,360 envs (horizon 32, 6 substeps) with its times, graphs
    and K2/K3 launches, and the device's idle share over one more graphed
    stage-1 epoch of tennis_main's learner (profiler). Returns that
    learner's newest state and the stage-2 epoch's launches."""
    import gc
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.ops import fk as FK
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    t_phase = time.perf_counter()
    out = {}
    gen = agent.env.gen

    def small():
        return _stage1_agent(dev, GRAPH_TENNIS_SMALL, gen, horizon=8, minibatch=16,
                             mini_epochs=2, episode=12, reaction=6, candidates=2)

    # the default mode: what differs
    learner = small()
    fresh = _snapshot(learner, learner.init_state())
    e1, e2 = (learner._train_epoch_eager(fresh()) for _ in range(2))
    g1 = learner.train_epoch(fresh())
    out["default_mode_stage1_8"] = dict(eager_vs_eager=_differ(*e2, *e1),
                                        graphed_vs_eager=_differ(*g1, *e1))
    del learner, fresh, e1, e2, g1

    # deterministic algorithms: graphed and eager bit for bit
    det = out["deterministic_mode"] = _deterministic_pairs("tennis_graphs", (
        ("stage1_8", small, 2),
        ("stage1_10240", lambda: _stage1_agent(dev, TENNIS_ENVS, gen, horizon=DET_HORIZON), 1)))

    # one graphed stage-2 epoch at full size
    stage2 = V2PPPO(stage2_env, V2PConfig(horizon=STAGE2_HORIZON, minibatch_size=STAGE2_MINIBATCH,
                                          mini_epochs=6, learning_rate=2e-5, sigma_init=-0.69,
                                          bounds_loss_coef=10.0), seed=7, device=dev)
    if not stage2.graphed:
        fail("tennis_graphs: the stage-2 learner does not take the graphs")
    ts2 = stage2.init_state()
    roll2, unwrap = _timed_rollouts(stage2)
    MOE.moe_linear.launches = MOE.split_weights.launches = FK.fk_chain.launches = 0
    try:
        ts2, m, s2_epoch = _timed_epoch(stage2.train_epoch, ts2)
    finally:
        unwrap()
    s2_launch = {"moe_linear": MOE.moe_linear.launches, "moe_split_w": MOE.split_weights.launches,
                 "fk_chain": FK.fk_chain.launches}
    s2_steps = stage2.num_minibatches * 6
    s2_metrics = {k: float(v) for k, v in m.items()}
    out["stage2_15360"] = dict(
        envs=STAGE2_ENVS, substeps=6, horizon=STAGE2_HORIZON, optimizer_steps=s2_steps,
        first_epoch_s=s2_epoch, rollout_s=roll2[0],
        optimizer_step_ms=(s2_epoch - roll2[0]) / s2_steps * 1e3, launches=s2_launch,
        graphs={g: _graph_stats(getattr(stage2._st, g)) for g in ("step", "update")},
        metrics={k: s2_metrics[k] for k in ("reward_mean", "done_rate", "kl", "c_loss",
                                            "grad_skip", "contact_rate")},
        obs_finite=bool(torch.isfinite(ts2.last_obs).all()))
    del stage2, ts2, m
    gc.collect()
    torch.cuda.empty_cache()

    # the device's idle share over one graphed stage-1 epoch (replays only)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts, _ = agent.train_epoch(ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in evs) * 1e-9
    out["stage1_profile"] = dict(wall_s=wall, device_busy_s=busy if evs else "not measured",
                                 device_idle_share=(1.0 - busy / wall) if evs
                                 else "not measured", device_events=len(evs),
                                 read_s=time.perf_counter() - t0,
                                 captures=[agent._st.step.captures, agent._st.update.captures])
    del prof, evs
    say("tennis_graphs", card=card, nvidia_smi=nvidia_smi(), phase_s=time.perf_counter() - t_phase,
        **out)

    _hold_deterministic_pairs("tennis_graphs", det)
    if out["stage1_profile"]["captures"] != [1, 1]:
        fail(f"tennis_graphs: tennis_main's graphs captured {out['stage1_profile']['captures']} "
             "times over three epochs")
    s2 = out["stage2_15360"]
    want = {"moe_linear": 3 * STAGE2_HORIZON, "moe_split_w": 3 * STAGE2_HORIZON,
            "fk_chain": 2 * STAGE2_HORIZON}
    if s2["launches"] != want:
        fail(f"tennis_graphs: the stage-2 epoch launched {s2['launches']}, expected {want}")
    if not all(math.isfinite(v) for v in s2_metrics.values()) or not s2["obs_finite"]:
        fail(f"tennis_graphs: the stage-2 epoch is not finite: {s2_metrics}")
    if s2_metrics["grad_skip"] != 0.0:
        fail(f"tennis_graphs: stage-2 grad_skip {s2_metrics['grad_skip']}")
    return ts, s2_launch


# ---------------------------------------------------------------------------
# phase 10: the stage-2 env
# ---------------------------------------------------------------------------

def stage2_phase(dev, card: str, agent, ts):
    import torch

    from vid2player3d_torch.envs import TennisConfig
    from vid2player3d_torch.ops import fk as FK

    t0 = time.perf_counter()
    env = _tennis_env(dev, TennisConfig(
        num_envs=STAGE2_ENVS, substeps=6, max_episode_length=300, reward_type="return_w_estimate",
        use_random_ball_target="discrete", reset_reaction_nframes=70, reset_candidates=256,
        ball_reaction_force=True, ball_body_contact=True), hidden=256, experts=6,
        gen=agent.env.gen)
    FK.fk_chain.launches = 0
    state, obs = env.reset_all()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_s = []
    finite = True
    with torch.no_grad():
        for _ in range(STAGE2_STEPS):
            t0 = time.perf_counter()
            mu, _ = agent._forward(ts.params, ts.obs_norm, obs)
            state, out = env.step(state, mu)
            obs = out.obs
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(out.obs).all())
    if not finite:
        fail("stage-2 obs not finite")
    k3 = FK.fk_chain.launches
    if k3 != 1 + 2 * STAGE2_STEPS:
        fail(f"K3 launched {k3} times in the stage-2 reset and {STAGE2_STEPS} steps, expected "
             f"{1 + 2 * STAGE2_STEPS}")
    say("stage2", card=card, envs=STAGE2_ENVS, substeps=6, steps=STAGE2_STEPS,
        obs_finite=finite, setup_s=setup_s, k3_launches=k3, ms_per_step=[s * 1e3 for s in step_s],
        env_steps_per_s=STAGE2_ENVS * (STAGE2_STEPS - 1) / sum(step_s[1:]))
    return env


# ---------------------------------------------------------------------------
# phase 11: a small dual-rally epoch on the card against the CPU
# ---------------------------------------------------------------------------

def dual_parity_phase(dev):
    """Two players (the left-handed lane with the two-hand backhand, its
    rows started in a backhand so the fix applies), two policies; the
    first place where a lane's strided rows reach K2 and K3 on the card."""
    import dataclasses

    import numpy as np
    import torch

    from vid2player3d_torch.envs import TennisConfig
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.ops import fk as FK
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    n, t, mb, me = 8, 4, 8, 2
    env_cfg = TennisConfig(num_envs=n, substeps=2, max_episode_length=40,
                           reward_type="return_w_estimate", use_random_ball_target="continuous",
                           ball_reaction_force=True, ball_body_contact=True, reset_candidates=0)
    v2p_cfg = V2PConfig(horizon=t, minibatch_size=mb, mini_epochs=me, actor_units=(64, 32),
                        critic_units=(64, 32), compute_dtype="f32", num_policies=2)
    pool = TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    reset_draws, draws = _tennis_draws(np.random.default_rng(1), n, t, me, pool.pool_size, 0,
                                       35, n_init=64, dual=True)
    metrics = {}
    for d in ("cpu", dev):
        gen = TennisBallGenerator.from_arrays(pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                              pool.launch_vspin, device=d)
        agent = V2PPPO(_dual_env(d, env_cfg, hidden=64, experts=3, gen=gen), v2p_cfg, seed=7,
                       device=d)
        ts = agent.init_state(reset_draws=reset_draws)
        mvae = ts.env_state.mvae
        swing = torch.where(agent.env.two_hand_mask, 2, mvae.swing_type).to(torch.int32)
        ts.env_state = dataclasses.replace(ts.env_state,
                                           mvae=dataclasses.replace(mvae, swing_type=swing))
        before = (MOE.moe_linear.launches, FK.fk_chain.launches)
        _, m = agent.train_epoch(ts, draws=draws)
        if d != "cpu" and (MOE.moe_linear.launches - before[0] != 6 * t
                           or FK.fk_chain.launches - before[1] != 2 * t):
            fail("the dual parity epoch did not launch K2 and K3 on the card")
        metrics[str(d)] = {k: float(v) for k, v in m.items()}
    ref, got = metrics["cpu"], metrics[str(dev)]
    worst = {}
    for k in ref:
        err = abs(got[k] - ref[k])
        worst[k] = err
        if not err <= PARITY_ATOL.get(k, 1e-5) + 1e-4 * abs(ref[k]):
            fail(f"card and CPU dual epochs disagree on {k}: {got[k]} vs {ref[k]}")
    say("dual_parity", envs=n, horizon=t, policies=2, metric_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 12: the dual rally (nadal_federer)
# ---------------------------------------------------------------------------

def _dual_agent(dev, n, gen=None, horizon=None, minibatch=None, mini_epochs=None,
                episode=300):
    """nadal_federer's learner at `n` envs (its sizes unless given):
    federer_train_stage_3's env with the dual changes (the full masked
    reset), two random full-width MVAEs and π_low, two policies."""
    from vid2player3d_torch.envs import TennisConfig
    from vid2player3d_torch.learn import V2PConfig, V2PPPO

    env_cfg = TennisConfig(num_envs=n, substeps=6, max_episode_length=episode,
                           reward_type="return_w_estimate", use_random_ball_target="continuous",
                           reset_reaction_nframes=70, reset_candidates=0,
                           ball_reaction_force=True, ball_body_contact=True)
    return V2PPPO(_dual_env(dev, env_cfg, hidden=256, experts=6, gen=gen), V2PConfig(
        horizon=horizon or DUAL_HORIZON, minibatch_size=minibatch or DUAL_MINIBATCH,
        mini_epochs=mini_epochs or DUAL_MINI_EPOCHS, learning_rate=1e-5, sigma_init=-2.9,
        bounds_loss_coef=10.0, num_policies=2), seed=7, device=dev)


def _in_backhand(env, mvae, phase=3.0):
    """`mvae` with the two-hand rows put into a backhand at `phase`."""
    import dataclasses

    import torch

    return dataclasses.replace(mvae, swing_type=torch.where(env.two_hand_mask, 2,
                                                            mvae.swing_type).to(torch.int32),
                               phase_pred=torch.full_like(mvae.phase_pred, phase))


def _ik_alone(env, mvae, reps: int = 5) -> dict:
    """The env's two-hand IK (`_apply_two_hand`, under `no_grad` as in the
    rollout) alone on `mvae`: ms per call eager (synchronized host clock)
    and replayed from a CUDA graph (`StaticGraph`, CUDA events), the graph,
    and the graphed result against the eager one; fails unless every
    backhand row of the two-hand rows moved and both results are finite and
    within the IK test's 1e-4."""
    import torch

    from vid2player3d_torch.utils import graphs

    def fix():
        with torch.no_grad():
            return env._apply_two_hand(mvae).joint_rotmat

    eager = fix()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eager = fix()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / reps * 1e3
    out = torch.empty_like(eager)
    g = graphs.StaticGraph(lambda: out.copy_(fix()), env.device)
    g()                                    # the warm-up run and the capture
    out.zero_()
    g()                                    # a replay
    torch.cuda.synchronize()
    err = float((out - eager).abs().max())
    moved = (eager - mvae.joint_rotmat).abs().amax(dim=(1, 2, 3))[env.two_hand_mask]
    if not (float(moved.min()) > 0.0 and bool(torch.isfinite(eager).all())
            and bool(torch.isfinite(out).all())):
        fail(f"the two-hand IK did not move every backhand row of the two-hand rows: "
             f"{float(moved.min())}")
    if not err <= 1e-4:
        fail(f"the two-hand IK replayed from a graph differs from the eager one by {err}")
    return dict(rows=int(eager.shape[0]), eager_ms=eager_ms,
                graph_ms=cuda_ms(g, reps), graph=_graph_stats(g),
                graphed_vs_eager_max_abs_err=err)


def _sync_checked_epoch(what, agent, ts):
    """One `train_epoch` under `torch.cuda.set_sync_debug_mode("error")`: a
    host sync anywhere in it (a read of a device value, a step that fell
    back to eager work that syncs) raises, and the phase fails. Its rollout
    is timed with CUDA events, which need no sync inside the epoch.
    Returns (the state, the metrics, the epoch's s on a synchronized host
    clock, the rollout's s)."""
    import torch

    name = "_rollout_graphed"
    rollout, events = getattr(agent, name), []

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = rollout(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    setattr(agent, name, timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, m = agent.train_epoch(ts)
    except RuntimeError as e:
        fail(f"{what}: a host sync in a replayed epoch: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        delattr(agent, name)
    torch.cuda.synchronize()
    return ts, m, time.perf_counter() - t0, events[0][0].elapsed_time(events[0][1]) / 1e3


def _graphed_epochs(what, agent, ts, epochs, want, checked=False, on_epoch=None):
    """`epochs` graphed `train_epoch`s of `agent` (the first captures both
    graphs, the rest replay them), the kernels' counters set to 0 just
    before each and read just after; with `checked` the last runs under
    `_sync_checked_epoch`; `on_epoch(agent)` after each. Fails unless each
    epoch launched `want` (K2 prep and GEMM, K3) and no K1, every metric is
    finite, `grad_skip` is 0 and each graph was captured once, in the first
    epoch. Returns (the state, the epochs' s, rollouts' s, metrics,
    launches, the graphs' stats with the captures per epoch, the peak
    GiB)."""
    import math

    import torch

    if not agent.graphed:
        fail(f"{what}: the learner does not take the graphs")
    torch.cuda.reset_peak_memory_stats()
    rollout_s, unwrap = _timed_rollouts(agent)
    epoch_s, rows, launches, captures = [], [], [], []
    try:
        for e in range(epochs):
            _zero_kernel_counts()
            before = _captures(agent)
            if checked and e == epochs - 1 and e > 0:
                unwrap()
                unwrap = _nothing
                ts, m, s, r = _sync_checked_epoch(what, agent, ts)
                rollout_s.append(r)
            else:
                ts, m, s = _timed_epoch(agent.train_epoch, ts)
            captures.append(_captures(agent) - before)
            epoch_s.append(s)
            rows.append({k: float(v) for k, v in m.items()})
            c = _kernel_counts()
            launches.append({"moe_linear": c["k2_gemm"], "moe_split_w": c["k2_prep"],
                             "fk_chain": c["k3"], "k1": c["k1_update"] + c["k1_norm"]})
            if on_epoch is not None:
                on_epoch(agent)
    finally:
        unwrap()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for e, got in enumerate(launches):
        if got != dict(want, k1=0):
            fail(f"{what}: epoch {e} launched {got}, expected {dict(want, k1=0)}")
    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"{what}: epoch {i}: non-finite metrics {bad}")
        if r["grad_skip"] != 0.0:
            fail(f"{what}: epoch {i}: grad_skip {r['grad_skip']}")
    steps = agent.num_minibatches * agent.cfg.mini_epochs
    if int(ts.opt_state.count) != epochs * steps:
        fail(f"{what}: optimizer count {int(ts.opt_state.count)}, expected {epochs * steps}")
    if not bool(torch.isfinite(ts.last_obs).all()):
        fail(f"{what}: the rollout's obs are not finite")
    stats = {g: _graph_stats(getattr(agent._st, g)) for g in ("step", "update")}
    stats["captures_per_epoch"] = captures
    if any(stats[g]["captures"] != 1 for g in ("step", "update")) or any(captures[1:]):
        fail(f"{what}: the graphs captured {captures} times over {epochs} epochs")
    return ts, epoch_s, rollout_s, rows, launches, stats, peak_gib


def _captures(agent) -> int:
    """The captures of a learner's step and update graphs so far."""
    st = agent._st
    return 0 if st is None else st.step.captures + st.update.captures


def dual_main_phase(dev, card: str):
    """nadal_federer at its sizes, graphed: two epochs, the first capturing
    the step and update graphs; K2 and K3 counted through the replays, per
    epoch; the two-hand IK alone at the full 15,360 rows, eager and
    replayed from a graph. Returns the learner, its state and the launches
    of one epoch."""
    import torch

    t0 = time.perf_counter()
    agent = _dual_agent(dev, DUAL_ENVS)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # per env step: each lane's decode (3 layers: a prep and a GEMM each);
    # K3 in the full masked reset and in the FK targets
    want = {"moe_linear": 6 * DUAL_HORIZON, "moe_split_w": 6 * DUAL_HORIZON,
            "fk_chain": 2 * DUAL_HORIZON}
    ts, epoch_s, rollout_s, rows, launches, stats, peak_gib = _graphed_epochs(
        "dual_main", agent, ts, DUAL_EPOCHS, want)
    if any(v.shape[0] != 2 for v in ts.params.values()):
        fail("the dual params are not stacked over two policies")

    # the two-hand IK alone at full size, on the carried kinematic state with
    # the left-handed lane's rows put into a backhand
    env = agent.env
    ik = _ik_alone(env, _in_backhand(env, ts.env_state.mvae))

    steps = agent.num_minibatches * DUAL_MINI_EPOCHS
    keep = ("hit_rate", "contact_rate", "racket_ball_dist", "racket_ball_dist_p90", "cycles",
            "done_rate", "reward_mean", "c_loss", "kl", "grad_skip", "est_bounce_in_rate")
    per_step_ms = [r / DUAL_HORIZON * 1e3 for r in rollout_s]
    say("dual_main", card=card, nvidia_smi=nvidia_smi(), config="nadal_federer",
        envs=DUAL_ENVS, lanes=2, horizon=DUAL_HORIZON, substeps=6, minibatch=DUAL_MINIBATCH,
        mini_epochs=DUAL_MINI_EPOCHS, epochs=DUAL_EPOCHS, graphed=agent.graphed,
        note="epoch 0 captures both graphs, epoch 1 replays them",
        compute_dtype=str(agent.compute_dtype), mvae="2 x (hidden 256, 6 experts, 288->290)",
        two_hand_iters=env.cfg.two_hand_iters, ball_pool=env.gen.pool_size, setup_s=setup_s,
        epoch_s=epoch_s, rollout_s=rollout_s, update_s=[e - r for e, r in zip(epoch_s, rollout_s)],
        rollout_env_steps_per_s=[DUAL_ENVS * DUAL_HORIZON / r for r in rollout_s],
        epoch_env_steps_per_s=[DUAL_ENVS * DUAL_HORIZON / e for e in epoch_s],
        rollout_ms_per_env_step=per_step_ms,
        optimizer_step_ms=[(e - r) / steps * 1e3 for e, r in zip(epoch_s, rollout_s)],
        two_hand_ik=ik, two_hand_ik_eager_share_of_replayed_step=ik["eager_ms"] / per_step_ms[-1],
        optimizer_steps_per_epoch=steps, launches_per_epoch=launches, graphs=stats,
        peak_mem_gib=peak_gib, metrics=[{k: r[k] for k in keep} for r in rows])
    one = {k: launches[-1][k] for k in ("moe_linear", "moe_split_w", "fk_chain")}
    return agent, ts, one


# the deterministic comparisons of the dual: 8 envs over two epochs of 4
# steps (episodes of 6 steps, so a done env takes the masked reset and its
# serve), and the full 15,360 envs over one epoch cut to horizon 4 (24
# optimizer steps of 15,360 rows); the eager dual step is host-bound (~2 s
# under deterministic algorithms at either size)
DUAL_DET_ENVS, DUAL_DET_HORIZON, DUAL_DET_EPISODE = 8, 4, 6
DUAL_DET_FULL_HORIZON, DUAL_DET_FULL_MINIBATCH = 4, 15360


def _deterministic_pairs(what, cases) -> dict:
    """Under `torch.use_deterministic_algorithms` (each learner captured in
    that mode), for each (name, make the learner, epochs[, start epoch]):
    the graphed epochs against eager ones from one state and one seed of
    each generator, what differs after each epoch, and with two or more
    epochs what differs between two eager first epochs; the times, the
    captures, the step graph; the ops the mode warned lack a deterministic
    form."""
    import gc
    import warnings

    import torch

    det = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name, make, epochs, *start in cases:
                learner = make()
                if not learner.graphed:
                    fail(f"{what}: the {name} learner does not take the graphs")
                ts0 = learner.init_state()
                ts0.epoch = start[0] if start else 0
                fresh = _snapshot(learner, ts0)
                a, b = fresh(), fresh()
                r = det[name] = dict(envs=learner.env.cfg.num_envs, horizon=learner.cfg.horizon,
                                     differ=[], graphed_epoch_s=[], eager_epoch_s=[])
                for e in range(epochs):
                    again = _snapshot(learner, b)
                    a, ma, tg = _timed_epoch(learner.train_epoch, a)
                    b, mb, te = _timed_epoch(learner._train_epoch_eager, again())
                    r["differ"].append(_differ(a, ma, b, mb))
                    r["graphed_epoch_s"].append(tg)
                    r["eager_epoch_s"].append(te)
                    if e == 0 and epochs > 1:
                        # two eager epochs agree in this mode
                        r["eager_vs_eager"] = _differ(*learner._train_epoch_eager(again()), b, mb)
                r["captures"] = [learner._st.step.captures, learner._st.update.captures]
                r["step_graph"] = _graph_stats(learner._st.step)
                del learner, fresh, a, b, again
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return dict(det, ops_without_a_deterministic_form=sorted(
        {str(w.message).split(" does not")[0][:80] for w in caught}))


def _hold_deterministic_pairs(what, det) -> None:
    """Fails unless every case of `_deterministic_pairs` was bit for bit,
    with one capture of each graph."""
    for name, r in det.items():
        if name != "ops_without_a_deterministic_form" and (
                any(r["differ"]) or r.get("eager_vs_eager") or r["captures"] != [1, 1]):
            fail(f"{what}: under deterministic algorithms the graphed {name} epochs differ "
                 f"from the eager ones: {r['differ']}, eager vs eager "
                 f"{r.get('eager_vs_eager')} (captures {r['captures']})")


def dual_graphs_phase(dev, card: str, gen):
    """The graphed dual epoch against the eager one under
    `torch.use_deterministic_algorithms` (the contact sums' `index_add`
    atomics make two eager epochs differ in the default mode): metrics,
    params, moments, count, both norms, env state and last obs bit for bit,
    at 8 envs over two epochs (two eager epochs agree too) and at 15,360
    envs over one short epoch."""
    t_phase = time.perf_counter()
    det = _deterministic_pairs("dual_graphs", (
        (f"dual_{DUAL_DET_ENVS}", lambda: _dual_agent(
            dev, DUAL_DET_ENVS, gen, horizon=DUAL_DET_HORIZON, minibatch=16, mini_epochs=2,
            episode=DUAL_DET_EPISODE), 2),
        (f"dual_{DUAL_ENVS}", lambda: _dual_agent(
            dev, DUAL_ENVS, gen, horizon=DUAL_DET_FULL_HORIZON,
            minibatch=DUAL_DET_FULL_MINIBATCH), 1)))
    say("dual_graphs", card=card, nvidia_smi=nvidia_smi(), phase_s=time.perf_counter() - t_phase,
        deterministic_mode=det)
    _hold_deterministic_pairs("dual_graphs", det)


# ---------------------------------------------------------------------------
# phase 12c: the single-player two-hand backhand (nadal)
# ---------------------------------------------------------------------------

TWOHAND_ENVS = 30720          # nadal's (and djokovic's) demo config: stage 3 at 30,720 envs


def _twohand_agent(dev, gen=None):
    """`nadal` at its sizes: federer_train_stage_3's env at 30,720 envs with
    the two-hand backhand, a left-handed random full-width nadal MVAE (seed
    0) and π_low (seed 0), 256 candidate resets; stage 3's learner (horizon
    32, minibatch 16,384, 6 mini-epochs: 360 optimizer steps)."""
    import dataclasses

    import torch

    from vid2player3d_torch.envs import TennisEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import FrozenImitator, V2PPPO
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    env_cfg, v2p_cfg = preset("nadal", num_envs=TWOHAND_ENVS)
    if not (env_cfg.two_hand_backhand and env_cfg.substeps == 6):
        fail(f"nadal's config is not stage 3 with the two-hand backhand: {env_cfg}")
    spec = dataclasses.replace(P.make_random_spec(0, player="nadal", hidden=256, experts=6,
                                                  device=dev), righthand=False)
    net = ImitatorNet(num_actions=75, generator=torch.Generator().manual_seed(0)).to(dev)
    pi_low = FrozenImitator(net=net, obs_norm=RN.RunningNormState.create(734, dev))
    if gen is None:
        gen = TennisBallGenerator(num_candidates=4096, seed=0, device=dev)
    env = TennisEnv(env_cfg, spec, _init_frames(), ball_generator=gen, pi_low=pi_low, device=dev)
    return V2PPPO(env, v2p_cfg, seed=7, device=dev)


def _record_k2_k3(env, state, action):
    """One eager `env.step` from `state` with K2's inputs (each MoE layer's,
    by batch) and K3's (by env count) recorded on the way; the hooks are
    removed after. Returns {"k2/<layer>/<B>": (x, coeff, w, b),
    "k3/<N>": (rot, off, root, parents)}."""
    import torch

    import vid2player3d_torch.envs.tennis as TEN
    from vid2player3d_torch.mvae.model import MoELayer

    seen, fk, handles = {}, TEN.fk_chain, []

    def record_fk(rot, off, root_pos, parents):
        seen.setdefault(f"k3/{rot.shape[0]}", (rot.clone(), off.clone(), root_pos.clone(),
                                               tuple(parents)))
        return fk(rot, off, root_pos, parents)

    for li, spec in enumerate(env._lane_specs):
        for mi, mod in enumerate(m for m in spec.decoder.modules() if isinstance(m, MoELayer)):
            def hook(module, args, key=f"k2/{mi}"):
                coeff, h = args
                seen.setdefault(f"{key}/{h.shape[0]}", (h.detach().clone(), coeff.detach().clone(),
                                                        module.w.detach(), module.b.detach()))
            handles.append(mod.register_forward_pre_hook(hook))
    TEN.fk_chain = record_fk
    try:
        with torch.no_grad():
            env.step(state, action)
    finally:
        TEN.fk_chain = fk
        for h in handles:
            h.remove()
    return seen


def twohand_main_phase(dev, card: str, gen):
    """nadal (left-handed, the two-hand backhand) at its 30,720 envs,
    graphed, one epoch: K2 and K3 counted through the replays against the
    code's count per step; K2 at B = 30,720 and K3 at N = 30,720 (and the
    candidates' 256) held to their plain versions on the inputs one more
    step from the epoch's state gives them, K2 timed there beside its bound
    and cuBLAS; the IK alone at 30,720 rows, eager and replayed from a graph,
    the graphed against the eager. Returns the epoch's launches and K2's
    times at B = 30,720."""
    import gc

    import torch

    from vid2player3d_torch.ops import fk as FK
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    t0 = time.perf_counter()
    agent = _twohand_agent(dev, gen)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    T = agent.cfg.horizon
    # per env step: one decode (3 prep + 3 GEMM); K3 in the candidate reset
    # (N = 256) and the FK targets (N = 30,720); the IK's FK is plain torch
    want = {"moe_linear": 3 * T, "moe_split_w": 3 * T, "fk_chain": 2 * T}
    ts, epoch_s, rollout_s, rows, launches, stats, peak_gib = _graphed_epochs(
        "twohand_main", agent, ts, 1, want)
    env = agent.env

    # K2 and K3 on the path's own inputs: one more step from the epoch's state
    with torch.no_grad():
        mu, _ = agent._forward(ts.params, ts.obs_norm, ts.last_obs)
    before = _kernel_counts()
    seen = _record_k2_k3(env, ts.env_state, mu)
    k2_in = [seen[f"k2/{mi}/{TWOHAND_ENVS}"] for mi in range(len(MOE_LAYERS))]
    k2_err = 0.0
    for a in k2_in:
        want_out = MOE.moe_linear_ref(*a)
        e = float((MOE.moe_linear(*a) - want_out).abs().max())
        k2_err = max(k2_err, e)
        if not e <= 1e-4 * max(1.0, float(want_out.abs().max())):
            fail(f"K2 disagrees with its plain version at B={TWOHAND_ENVS} on nadal's inputs: {e}")
    k3_err = {}
    for n in (TWOHAND_ENVS, env.cfg.reset_candidates):
        args = seen[f"k3/{n}"]
        k3_err[n] = max(float((a - b).abs().max())
                        for a, b in zip(FK.fk_chain(*args), FK._fk_plain(*args)))
    if any(k3_err.values()):
        fail(f"K3 disagrees with its plain version on nadal's inputs: {k3_err}")
    k2 = _k2_times(dev, card, TWOHAND_ENVS, None, k2_in)
    # the comparison's and timing's launches are not the main path's
    FK.fk_chain.launches, MOE.moe_linear.launches, MOE.split_weights.launches = (
        before["k3"], before["k2_gemm"], before["k2_prep"])
    del seen, k2_in

    ik = _ik_alone(env, _in_backhand(env, ts.env_state.mvae))
    steps = agent.num_minibatches * agent.cfg.mini_epochs
    keep = ("hit_rate", "contact_rate", "racket_ball_dist", "cycles", "done_rate", "reward_mean",
            "c_loss", "kl", "grad_skip")
    k2_keys = ("ms", "graph_ms", "plain_ms", "plain_graph_ms", "library_ms", "library_graph_ms",
               "bound_ms", "bound_by", "f32_simt_bound_ms", "share_of_3xtf32_bound",
               "achieved_tflops", "flops")
    say("twohand_main", card=card, nvidia_smi=nvidia_smi(), config="nadal", envs=TWOHAND_ENVS,
        horizon=T, substeps=env.cfg.substeps, candidates=env.cfg.reset_candidates,
        two_hand_iters=env.cfg.two_hand_iters, righthand=False, graphed=agent.graphed,
        note="one epoch: it captures both graphs", setup_s=setup_s, epoch_s=epoch_s,
        rollout_s=rollout_s, update_s=[e - r for e, r in zip(epoch_s, rollout_s)],
        rollout_ms_per_env_step=[r / T * 1e3 for r in rollout_s],
        optimizer_steps_per_epoch=steps,
        optimizer_step_ms=[(e - r) / steps * 1e3 for e, r in zip(epoch_s, rollout_s)],
        epoch_env_steps_per_s=[TWOHAND_ENVS * T / e for e in epoch_s],
        launches_per_epoch=launches, launches_per_env_step={k: v // T for k, v in want.items()},
        graphs=stats, peak_mem_gib=peak_gib, two_hand_ik=ik,
        k2_B30720=dict({k: k2[k] for k in k2_keys}, max_abs_err=k2_err, tol=1e-4),
        k3_max_abs_err=k3_err, metrics=[{k: r[k] for k in keep} for r in rows])
    one = {k: launches[-1][k] for k in ("moe_linear", "moe_split_w", "fk_chain")}
    del agent, ts
    gc.collect()
    torch.cuda.empty_cache()
    return one, dict({k: k2[k] for k in k2_keys}, max_abs_err=k2_err)


def twohand_eager_phase(dev, card: str, gen=None):
    """One eager epoch of twohand_main's learner (`_train_epoch_eager`, every
    op dispatched from the host), for comparison with the graphed one; not
    run by `main`. Alone: `python3 -c "import sys; sys.path.insert(0, '.');
    import torch, chip_smoke as C; from vid2player3d_torch.ops import build;
    build.build_kernels(); d = torch.device('cuda', 0); c =
    torch.cuda.get_device_name(0); C.twohand_main_phase(d, c, None);
    C.twohand_eager_phase(d, c)"`."""
    import gc

    import torch

    agent = _twohand_agent(dev, gen)
    ts = agent.init_state()
    times = []
    _wrap_timer(agent, "_rollout_eager", times)
    try:
        ts, m, epoch_s = _timed_epoch(agent._train_epoch_eager, ts)
    finally:
        delattr(agent, "_rollout_eager")
    T = agent.cfg.horizon
    steps = agent.num_minibatches * agent.cfg.mini_epochs
    say("twohand_eager", card=card, nvidia_smi=nvidia_smi(), config="nadal", envs=TWOHAND_ENVS,
        horizon=T, epoch_s=epoch_s, rollout_s=times[0],
        rollout_ms_per_env_step=times[0] / T * 1e3,
        optimizer_step_ms=(epoch_s - times[0]) / steps * 1e3,
        grad_skip=float(m["grad_skip"]), reward_mean=float(m["reward_mean"]))
    del agent, ts
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 13-17: domain randomization and the context IK (slice 4)
# ---------------------------------------------------------------------------

def _imitation_draws(rng, agent, n, t, me):
    """Explicit draws for a small imitation epoch, those of the env's
    randomization and corruption included, so two devices run the same
    epoch."""
    import numpy as np

    env, a = agent.env, agent.num_actions
    draws = {"motion_times": (rng.random(n) * 0.8).astype(np.float32),
             "noise": rng.standard_normal((t, n, a)).astype(np.float32),
             "perms": np.stack([rng.permutation(n * t) for _ in range(me)])}
    dr = env.randomizer
    if dr is not None:
        draws["dr_model"] = [rng.random(n) for _ in dr.model_specs]
        draws["dr_act"] = [[rng.standard_normal((n, a)) for _ in dr.act_specs] for _ in range(t)]
        draws["dr_obs"] = [[rng.standard_normal((n, env.obs_dim)) for _ in dr.obs_specs]
                           for _ in range(t)]
    if env.cfg.transform_specs is not None:
        shape = (n, env.cfg.context_length + 2 * env.cfg.context_padding, 24)
        draws["corrupt"] = {"sel_u": rng.random(shape), "noise": rng.standard_normal(shape + (3,)),
                            "drop_u": rng.random(shape)}
    return draws


def _small_imitation_epoch(dev, name, epoch, draws_seed, n=4, t=4, mb=8, me=2):
    """One small f32 epoch of a named imitation configuration on `dev` from
    `epoch` (the schedule step is epoch·horizon); (metrics, the agent, K1's
    launches)."""
    import dataclasses

    import numpy as np

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO
    from vid2player3d_torch.ops import fused_adam as FA

    env_cfg, ppo_cfg = preset(name, num_envs=n, substeps=2)
    env = HumanoidImEnv(env_cfg, make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=dev),
                        motion_ids=np.array([0, 1, 1, 0]), device=dev)
    agent = ImitationPPO(env, dataclasses.replace(ppo_cfg, horizon=t, minibatch_size=mb,
                                                  mini_epochs=me, compute_dtype="f32",
                                                  fused_optimizer="on"), seed=7, device=dev)
    ts = agent.init_state()
    ts.epoch = epoch
    draws = _imitation_draws(np.random.default_rng(draws_seed), agent, n, t, me)
    before = FA.leaf_update.launches + FA.global_norm_scalars.launches
    _, m = agent.train_epoch(ts, draws=draws)
    launched = FA.leaf_update.launches + FA.global_norm_scalars.launches - before
    return {k: float(v) for k, v in m.items()}, agent, launched


def _compare(phase, ref, got, what):
    worst = {}
    for k in ref:
        err = abs(got[k] - ref[k])
        worst[k] = err
        if not err <= PARITY_ATOL.get(k, 1e-5) + 1e-4 * abs(ref[k]):
            fail(f"{phase}: card and CPU {what} disagree on {k}: {got[k]} vs {ref[k]}")
    return worst


def dr_parity_phase(dev):
    """A small amass_im_dr imitation epoch (4 envs, f32, the config's four
    specs, from epoch 300 so the scheduled noise is on) and a small
    federer_train_stage_1_dr tennis epoch (8 envs, test widths, the config's
    four specs, from epoch 400) on the card against the CPU with the same
    draws."""
    import dataclasses

    import numpy as np

    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    im = {}
    for d in ("cpu", dev):
        m, agent, launched = _small_imitation_epoch(d, "amass_im_dr", 300, 2)
        if d != "cpu" and launched != 2 * 4:
            fail(f"dr_parity: K1 launched {launched} times in 4 optimizer steps")
        im[str(d)] = m
    im_err = _compare("dr_parity", im["cpu"], im[str(dev)], "DR imitation epochs")

    n, t, mb, me, epoch = 8, 4, 8, 2, 400
    env_cfg, _ = preset("federer_train_stage_1_dr", num_envs=n, max_episode_length=40,
                        reset_reaction_nframes=6, reset_candidates=2)
    v2p_cfg = V2PConfig(horizon=t, minibatch_size=mb, mini_epochs=me, actor_units=(64, 32),
                        critic_units=(64, 32), compute_dtype="f32")
    pool = TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    reset_draws, draws = _tennis_draws(rng, n, t, me, pool.pool_size, 2, 35, n_init=64)
    draws.update(dr_ball=[rng.random(), rng.random()],
                 dr_act=[[rng.standard_normal((n, 35))] for _ in range(t)],
                 dr_obs=[[rng.standard_normal((n, 257))] for _ in range(t)])
    tennis, balls = {}, {}
    for d in ("cpu", dev):
        gen = TennisBallGenerator.from_arrays(pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                              pool.launch_vspin, device=d)
        agent = V2PPPO(_tennis_env(d, dataclasses.replace(env_cfg, substeps=2), hidden=64,
                                   experts=3, gen=gen), v2p_cfg, seed=7, device=d)
        ts = agent.init_state(reset_draws=reset_draws)
        ts.epoch = epoch
        _, m = agent.train_epoch(ts, draws=draws)
        tennis[str(d)] = {k: float(v) for k, v in m.items()}
        balls[str(d)] = [float(v) for v in agent.last_env.ball_params]
    if not (np.allclose(balls["cpu"], balls[str(dev)], rtol=1e-6, atol=0.0)
            and balls["cpu"] != [float(v) for v in agent.env.ball_params]):
        fail(f"dr_parity: ball constants {balls}")
    tennis_err = _compare("dr_parity", tennis["cpu"], tennis[str(dev)], "DR tennis epochs")
    say("dr_parity", imitation=dict(config="amass_im_dr", envs=4, horizon=4, epoch=300,
                                    metric_abs_err=im_err),
        tennis=dict(config="federer_train_stage_1_dr", envs=n, horizon=t, epoch=epoch,
                    ball_params=balls[str(dev)], metric_abs_err=tennis_err))


def _ik_case(b, seed=0):
    """Seeded moderate poses (the SMPL FK of random angle-axis), the rest
    pose and random twist / leaf residuals, on the CPU."""
    import numpy as np
    import torch

    from vid2player3d_torch.core import rot as R
    from vid2player3d_torch.core import smpl as S

    rng = np.random.default_rng(seed)
    rest = S.rest_joints(S.make_synthetic_smpl(), torch.zeros(b, 10))
    aa = torch.tensor(rng.uniform(-0.4, 0.4, (b, 24, 3)).astype(np.float32))
    posed, _ = S.batch_rigid_transform(R.angle_axis_to_rotmat(aa), rest)
    return (posed, rest, torch.tensor(0.1 * rng.standard_normal((b, 46)).astype(np.float32)),
            torch.tensor(0.1 * rng.standard_normal((b, 30)).astype(np.float32)))


def ctx_parity_phase(dev):
    """A small amass_im_corrupt epoch (4 envs, f32, 24 leaves) on the card
    against the CPU with the same draws, and the context IK alone at the
    minibatch's B = 512 on the card against the CPU (rotations, joints and
    the gradient into the heads' residuals: 1e-4 of their scale)."""
    import torch

    from vid2player3d_torch.core import ik as IK

    ctx = {}
    for d in ("cpu", dev):
        m, agent, launched = _small_imitation_epoch(d, "amass_im_corrupt", 0, 4)
        if d != "cpu" and (launched != 2 * 4 or len(agent.init_state().params) != 24):
            fail(f"ctx_parity: K1 launched {launched} times in 4 optimizer steps")
        ctx[str(d)] = m
    err = _compare("ctx_parity", ctx["cpu"], ctx[str(dev)], "context-IK epochs")

    outs = {}
    for d in ("cpu", dev):
        posed, rest, phis, leaf = (x.to(d) for x in _ik_case(512))
        phis.requires_grad_(True)
        leaf.requires_grad_(True)
        out = IK.perform_context_ik(posed, rest, phis, leaf)
        loss = (out[0] ** 2).sum() * 0.1 + (out[1][..., 0] ** 3).sum() + out[2].sum()
        outs[str(d)] = [x.detach().cpu() for x in out + torch.autograd.grad(loss, (phis, leaf))]
    ik_err = []
    for name, a, g in zip(("local", "chain", "joints", "d_phis", "d_leaf"), outs["cpu"],
                          outs[str(dev)]):
        e = float((a - g).abs().max())
        ik_err.append(e)
        if not (bool(torch.isfinite(g).all()) and e <= 1e-4 * max(1.0, float(a.abs().max()))):
            fail(f"ctx_parity: the IK on the card disagrees on {name}: {e}")
    say("ctx_parity", config="amass_im_corrupt", envs=4, horizon=4, metric_abs_err=err,
        ik_B=512, ik_max_abs_err=dict(zip(("local", "chain", "joints", "d_phis", "d_leaf"),
                                          ik_err)))


def _imitation_main(dev, name, epochs, mini_epochs=MINI_EPOCHS, lib=None, checked=False):
    """`epochs` epochs of a named imitation configuration at the main path's
    sizes (4096 envs, full width, fused K1; `mini_epochs` passes per epoch)
    on `lib` (by default the synthetic 8 motions x 300 frames), replayed
    from graphs (the first epoch captures), with K1's counters set to 0 just
    before and read just after; with `checked` the last epoch runs under
    `_sync_checked_epoch`. Fails on a capture after the first epoch. Returns
    (agent, ts, rows, K1 launches, each epoch's env, timings and graphs)."""
    import dataclasses
    import math

    import torch

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO
    from vid2player3d_torch.ops import fused_adam as FA

    t0 = time.perf_counter()
    env_cfg, ppo_cfg = preset(name, num_envs=NUM_ENVS, substeps=SUBSTEPS)
    if lib is None:
        lib = make_synthetic_motion_lib(num_motions=8, T=300, fps=30.0, seed=0, device=dev)
    agent = ImitationPPO(HumanoidImEnv(env_cfg, lib, rng=0, device=dev),
                         dataclasses.replace(ppo_cfg, horizon=HORIZON, minibatch_size=MINIBATCH,
                                             mini_epochs=mini_epochs, fused_optimizer="on"),
                         seed=7, device=dev)
    if not agent.graphed:
        fail(f"{name}: the learner does not take the graphs")
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps_per_epoch = agent.num_minibatches * mini_epochs

    rollout_s, unwrap = _timed_rollouts(agent)
    torch.cuda.reset_peak_memory_stats()
    FA.leaf_update.launches = FA.global_norm_scalars.launches = 0
    epoch_s, rows, envs, captures = [], [], [], []
    try:
        for e in range(epochs):
            before = _captures(agent)
            if checked and e == epochs - 1 and e > 0:
                unwrap()
                unwrap = _nothing
                ts, m, s, r = _sync_checked_epoch(name, agent, ts)
                rollout_s.append(r)
            else:
                ts, m, s = _timed_epoch(agent.train_epoch, ts)
            captures.append(_captures(agent) - before)
            epoch_s.append(s)
            rows.append({k: float(v) for k, v in m.items()})
            envs.append(agent.last_env)
    finally:
        unwrap()
    launches = {"update": FA.leaf_update.launches, "norm": FA.global_norm_scalars.launches}
    expected = epochs * steps_per_epoch * -(-len(ts.params) // 64)
    if launches != {"update": expected, "norm": expected}:
        fail(f"{name}: K1 launched {launches} times, expected {expected} each")
    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"{name} epoch {i}: non-finite metrics {bad}")
        if not r["alive_ratio"] > 0.5:
            fail(f"{name} epoch {i}: alive_ratio {r['alive_ratio']}")
    if int(ts.opt_state.count) != epochs * steps_per_epoch:
        fail(f"{name}: optimizer count {int(ts.opt_state.count)}")
    graphs = {g: _graph_stats(getattr(agent._st, g)) for g in ("step", "update")}
    graphs["captures_per_epoch"] = captures
    if any(graphs[g]["captures"] != 1 for g in ("step", "update")) or any(captures[1:]):
        fail(f"{name}: the graphs captured {captures} times over {epochs} epochs")
    timing = dict(setup_s=setup_s, epoch_s=epoch_s, rollout_s=rollout_s,
                  update_s=[e - r for e, r in zip(epoch_s, rollout_s)],
                  rollout_ms_per_env_step=[r / HORIZON * 1e3 for r in rollout_s],
                  optimizer_step_ms=[(e - r) / steps_per_epoch * 1e3
                                     for e, r in zip(epoch_s, rollout_s)],
                  rollout_env_steps_per_s=[NUM_ENVS * HORIZON / r for r in rollout_s],
                  epoch_env_steps_per_s=[NUM_ENVS * HORIZON / e for e in epoch_s],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  optimizer_steps_per_epoch=steps_per_epoch, graphs=graphs,
                  note="epoch 0 captures both graphs, the later ones replay them"
                       + ("; the last under the sync check (its rollout timed with CUDA "
                          "events)" if checked and epochs > 1 else ""))
    return agent, ts, rows, launches, envs, timing


def im_dr_main_phase(dev, card: str):
    """amass_im_dr at the main path's sizes, two epochs replayed from graphs
    (the second under the sync check): K1's launches through the replays,
    each epoch's perturbed model (drawn from the base model: it differs from
    the base and from the other epoch's and lies inside the specs' ranges of
    the base; each epoch's `last_env` keeps its own) and the schedule's
    strength per epoch."""
    import torch

    from vid2player3d_torch.envs.domain_rand import _sched_scale

    agent, ts, rows, launches, envs, timing = _imitation_main(dev, "amass_im_dr", SLICE4_EPOCHS,
                                                              checked=True)
    base = agent.env.model
    dr = agent.env.randomizer
    ranges = {}
    for sp in dr.model_specs:
        lo, hi = sp.rng
        r = [(getattr(e.model, sp.field) / getattr(base, sp.field)) for e in envs]
        for x in r:
            if not (float(x.min()) >= lo - 1e-6 and float(x.max()) <= hi + 1e-6):
                fail(f"im_dr_main: {sp.field} factor outside [{lo}, {hi}]")
        if any(torch.equal(x, torch.ones_like(x)) for x in r) or torch.equal(r[0], r[-1]):
            fail(f"im_dr_main: an epoch stepped the base {sp.field}, or both the same one")
        ranges[sp.field] = [[float(x.min()), float(x.max())] for x in r]
    scales = {sp.field: [_sched_scale(sp, e * HORIZON) for e in range(SLICE4_EPOCHS)]
              for sp in dr.obs_specs + dr.act_specs}
    keep = ("reward_mean", "alive_ratio", "a_loss", "c_loss", "kl", "clip_frac")
    say("im_dr_main", card=card, nvidia_smi=nvidia_smi(), config="amass_im_dr", envs=NUM_ENVS,
        horizon=HORIZON, minibatch=MINIBATCH, mini_epochs=MINI_EPOCHS, epochs=SLICE4_EPOCHS,
        cut="8192 -> 4096 envs, 2 epochs", compute_dtype=str(agent.compute_dtype),
        leaves=len(ts.params), graphed=agent.graphed,
        k1_launches=launches, model_factor_ranges=ranges, schedule_scale_per_epoch=scales,
        metrics=[{k: r[k] for k in keep} for r in rows], **timing)
    return launches


def _ctx_ik_alone(agent, ts, dev) -> dict:
    """The context IK alone at the main path's sizes, per rollout step (the
    4096 envs' targets) and per optimizer step (the 512-row minibatch's IK,
    forward and backward into the heads): eager on a synchronized host
    clock with the host syncs each call makes (fails unless 0), and
    replayed from a graph (CUDA events)."""
    import warnings

    import torch

    from vid2player3d_torch.utils import graphs

    env = agent.env
    _, _, ctx = env.reset_all(ts.generator)
    cb_pos = agent._ctx_frame(ctx["feat"], 0)[0]
    conf = ctx["conf"][:, env.cfg.context_padding]
    rest = env.rest_joints_smpl
    mb = torch.randperm(NUM_ENVS, device=dev)[:MINIBATCH]
    ctx_params = [v for k, v in ts.params.items() if k.startswith("ctx.")]

    def rollout_ik():
        with torch.no_grad():
            return agent._context_targets(ts.params, cb_pos, conf, rest)

    def update_ik():
        out = agent._context_targets(ts.params, cb_pos[mb], conf[mb], rest[mb])
        return torch.autograd.grad(sum(x.sum() for x in out), ctx_params)

    out, reps = {}, 5
    for name, fn in (("rollout_step", rollout_ik), ("optimizer_step", update_ik)):
        want = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = out[name + "_host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
        if syncs:
            fail(f"im_ctx_main: the context IK per {name} made {syncs} host syncs")
        static = [torch.empty_like(x) for x in want]
        g = graphs.StaticGraph(lambda: [s.copy_(x) for s, x in zip(static, fn())], dev)
        g()
        out[name + "_graph_ms"] = cuda_ms(g, reps * 4)
        out[name + "_graph"] = _graph_stats(g)
        err = max(float((s - x).abs().max()) for s, x in zip(static, want))
        if not err <= 1e-5 * max(1.0, max(float(x.abs().max()) for x in want)):
            fail(f"im_ctx_main: the replayed context IK per {name} differs by {err}")
        out[name + "_graph_vs_eager_max_abs_err"] = err
    return out


def im_ctx_main_phase(dev, card: str):
    """amass_im_corrupt at the main path's sizes, two epochs of 2
    mini-epochs (24 leaves) replayed from graphs, the second under the sync
    check: K1's launches through the replays and finite auxiliary losses;
    then the context IK alone (`_ctx_ik_alone`), eager and replayed."""
    agent, ts, rows, launches, _, timing = _imitation_main(
        dev, "amass_im_corrupt", SLICE4_EPOCHS, CTX_MINI_EPOCHS, checked=True)
    for i, r in enumerate(rows):
        if not r["aux_dof_loss"] > 0.0:
            fail(f"im_ctx_main epoch {i}: aux_dof_loss {r['aux_dof_loss']}")
    if len(ts.params) != 24:
        fail(f"im_ctx_main: {len(ts.params)} leaves")
    ik = _ctx_ik_alone(agent, ts, dev)
    per_step_ms = timing["rollout_ms_per_env_step"]
    keep = ("reward_mean", "alive_ratio", "a_loss", "c_loss", "kl", "aux_dof_loss",
            "aux_pos_loss")
    say("im_ctx_main", card=card, nvidia_smi=nvidia_smi(), config="amass_im_corrupt",
        envs=NUM_ENVS, horizon=HORIZON, minibatch=MINIBATCH, mini_epochs=CTX_MINI_EPOCHS,
        epochs=SLICE4_EPOCHS, cut="8192 -> 4096 envs, 2 epochs of 2 mini-epochs",
        compute_dtype=str(agent.compute_dtype), graphed=agent.graphed,
        leaves=len(ts.params), k1_launches=launches, ik=ik,
        ik_replayed_share_of_rollout_step=ik["rollout_step_graph_ms"] / per_step_ms[-1],
        ik_replayed_share_of_optimizer_step=(ik["optimizer_step_graph_ms"]
                                             / timing["optimizer_step_ms"][-1]),
        metrics=[{k: r[k] for k in keep} for r in rows], **timing)
    return launches


def tennis_dr_main_phase(dev, card: str):
    """federer_train_stage_1_dr at its own sizes (10,240 envs, the federer
    MVAE width, full-width pi_low and V2PNet), two epochs replayed from
    graphs (the second under the sync check): K2 and K3's launches through
    the replays, no skipped update, and each epoch's ball constants (they
    differ from the base and from each other and lie inside the specs'
    ranges of the base)."""
    import torch

    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import V2PPPO

    t0 = time.perf_counter()
    env_cfg, v2p_cfg = preset("federer_train_stage_1_dr")
    agent = V2PPPO(_tennis_env(dev, env_cfg, hidden=256, experts=6), v2p_cfg, seed=7, device=dev)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps_per_epoch = agent.num_minibatches * v2p_cfg.mini_epochs
    horizon = v2p_cfg.horizon
    want = {"moe_linear": 3 * horizon, "moe_split_w": 3 * horizon, "fk_chain": 2 * horizon}
    balls = []
    ts, epoch_s, rollout_s, rows, launches, stats, peak_gib = _graphed_epochs(
        "tennis_dr_main", agent, ts, SLICE4_EPOCHS, want, checked=True,
        on_epoch=lambda a: balls.append(a.last_env.ball_params))
    base = agent.env.ball_params
    consts = {}
    for sp in agent.env.randomizer.ball_specs:
        name = sp.field[len("ball_"):]
        vals = [float(getattr(b, name)) for b in balls]
        f = [v / getattr(base, name) for v in vals]
        if (not all(sp.rng[0] - 1e-6 <= x <= sp.rng[1] + 1e-6 for x in f) or 1.0 in f
                or len(set(vals)) != len(vals)):
            fail(f"DR tennis: {name} per epoch {vals} against {getattr(base, name)}")
        consts[name] = vals
    keep = ("hit_rate", "contact_rate", "racket_ball_dist", "cycles", "done_rate", "reward_mean",
            "c_loss", "kl", "grad_skip")
    say("tennis_dr_main", card=card, nvidia_smi=nvidia_smi(), config="federer_train_stage_1_dr",
        envs=env_cfg.num_envs, horizon=horizon, substeps=env_cfg.substeps,
        minibatch=v2p_cfg.minibatch_size, mini_epochs=v2p_cfg.mini_epochs, epochs=SLICE4_EPOCHS,
        cut="2 epochs", compute_dtype=str(agent.compute_dtype), mvae="hidden 256, 6 experts",
        graphed=agent.graphed, note="epoch 0 captures both graphs, epoch 1 replays them under "
        "the sync check (its rollout timed with CUDA events)",
        ball_constants_per_epoch=consts, setup_s=setup_s, epoch_s=epoch_s, rollout_s=rollout_s,
        update_s=[e - r for e, r in zip(epoch_s, rollout_s)],
        rollout_ms_per_env_step=[r / horizon * 1e3 for r in rollout_s],
        optimizer_step_ms=[(e - r) / steps_per_epoch * 1e3 for e, r in zip(epoch_s, rollout_s)],
        rollout_env_steps_per_s=[env_cfg.num_envs * horizon / r for r in rollout_s],
        epoch_env_steps_per_s=[env_cfg.num_envs * horizon / e for e in epoch_s],
        optimizer_steps_per_epoch=steps_per_epoch, launches_per_epoch=launches, graphs=stats,
        peak_mem_gib=peak_gib, metrics=[{k: r[k] for k in keep} for r in rows])
    return {k: launches[-1][k] for k in ("moe_linear", "moe_split_w", "fk_chain")}


# the deterministic comparisons of the context-IK and domain-randomized
# epochs: 8 envs, horizon 4, two epochs each (the DR ones from epoch 300,
# where the linear noise is on and grows), so a stale schedule or stale
# constants in the second epoch would show
CTX_DR_DET_ENVS, CTX_DR_DET_EPOCH = 8, 300


def _small_imitation_learner(dev, name, n):
    """A small learner of a named imitation configuration: `n` envs, horizon
    4, minibatch 8, 2 mini-epochs, the card's compute dtype, fused K1."""
    import dataclasses

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO

    env_cfg, ppo_cfg = preset(name, num_envs=n, substeps=2)
    env = HumanoidImEnv(env_cfg, make_synthetic_motion_lib(num_motions=2, T=60, seed=0,
                                                           device=dev), rng=0, device=dev)
    return ImitationPPO(env, dataclasses.replace(ppo_cfg, horizon=4, minibatch_size=8,
                                                 mini_epochs=2, fused_optimizer="on"),
                        seed=7, device=dev)


def _small_dr_tennis_learner(dev, n, gen=None):
    """federer_train_stage_1_dr at `n` envs and test widths (MVAE hidden 64,
    3 experts; trunks (64, 32)), horizon 4, episodes of 6 steps."""
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import V2PConfig, V2PPPO

    env_cfg, _ = preset("federer_train_stage_1_dr", num_envs=n, max_episode_length=6,
                        reset_reaction_nframes=6, reset_candidates=2)
    return V2PPPO(_tennis_env(dev, env_cfg, hidden=64, experts=3, gen=gen),
                  V2PConfig(horizon=4, minibatch_size=8, mini_epochs=2, actor_units=(64, 32),
                            critic_units=(64, 32)), seed=7, device=dev)


def ctx_dr_graphs_phase(dev, card: str):
    """The graphed context-IK and domain-randomized epochs against the eager
    ones under `torch.use_deterministic_algorithms` (each learner captured
    in that mode): amass_im_corrupt, amass_im_dr and
    federer_train_stage_1_dr at 8 envs over two epochs, metrics, params,
    moments, count, both norms (and the tennis env state and last obs) bit
    for bit, two eager epochs agreeing too."""
    t_phase = time.perf_counter()
    n, e0 = CTX_DR_DET_ENVS, CTX_DR_DET_EPOCH
    det = _deterministic_pairs("ctx_dr_graphs", (
        ("amass_im_corrupt", lambda: _small_imitation_learner(dev, "amass_im_corrupt", n), 2),
        ("amass_im_dr", lambda: _small_imitation_learner(dev, "amass_im_dr", n), 2, e0),
        ("federer_train_stage_1_dr", lambda: _small_dr_tennis_learner(dev, n), 2, e0)))
    say("ctx_dr_graphs", card=card, nvidia_smi=nvidia_smi(),
        phase_s=time.perf_counter() - t_phase, deterministic_mode=det)
    _hold_deterministic_pairs("ctx_dr_graphs", det)


# ---------------------------------------------------------------------------
# phases 18-20: slice 5's checkpoints, the MotionVAE trainer
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(REPO, "build", "chip_smoke_ckpt")
MVAE_EPOCHS, MVAE_BATCHES = 2, 50       # cut from the config's 500 epochs x 500 windows
MVAE_START_EPOCH = 75                   # mid-curriculum: teacher-forced and regressive windows
MVAE_REPORT_STEPS, MVAE_REPORT_ENVS, MVAE_TENNIS_STEPS = 120, 8, 8


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(what, a, b):
    """Bit-for-bit equality of two tensors, or the phase fails."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        fail(f"{what}: {a.dtype} {tuple(a.shape)} against {b.dtype} {tuple(b.shape)}, "
             "values differ")


def _same_learner_state(what, a, b):
    for k in a.params:
        _same(f"{what} param {k}", a.params[k].detach(), b.params[k].detach())
    for i, (m0, m1, v0, v1) in enumerate(zip(a.opt_state.mu, b.opt_state.mu, a.opt_state.nu,
                                             b.opt_state.nu)):
        _same(f"{what} mu[{i}]", m0, m1)
        _same(f"{what} nu[{i}]", v0, v1)
    _same(f"{what} count", a.opt_state.count.to(b.opt_state.count.device), b.opt_state.count)
    for n in ("obs_norm", "val_norm"):
        for f in ("n", "mean", "var"):
            _same(f"{what} {n}.{f}", getattr(getattr(a, n), f), getattr(getattr(b, n), f))
    if a.epoch != b.epoch or float(a.lr) != float(b.lr):
        fail(f"{what}: epoch/lr {a.epoch}/{float(a.lr)} against {b.epoch}/{float(b.lr)}")


def ckpt_phase(dev, card: str, agent, ts, stage2_env, dual_agent, im_agent, im_ts, lib):
    """The port's checkpoints on the card: the stage-1 learner's file read
    back bit for bit; its warm start into a stage-2 learner (surgery with
    unchanged dims: every leaf carried, lr dropped to stage 2's) stepped 8
    times with K3 counted; into the dual learner (each lane the single
    policy); the imitation learner's bf16 moments; the ball pool and the
    motion library."""
    import dataclasses
    import math

    import torch

    from vid2player3d_torch.data.motion_lib import MotionLib
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.ops import fk as FK
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    os.makedirs(CKPT_DIR, exist_ok=True)
    times = {}
    path = os.path.join(CKPT_DIR, "stage1.npz")
    _, times["stage1_save_s"] = _timed(lambda: agent.save_checkpoint(path, ts))
    back, times["stage1_load_s"] = _timed(lambda: agent.load_checkpoint(path))
    _same_learner_state("stage-1 checkpoint", ts, back)

    stage2 = V2PPPO(stage2_env, V2PConfig(horizon=32, minibatch_size=16384, mini_epochs=6,
                                          learning_rate=2e-5, sigma_init=-0.69,
                                          bounds_loss_coef=10.0), seed=7, device=dev)
    FK.fk_chain.launches = 0
    ts2, times["stage2_warm_start_s"] = _timed(lambda: stage2.load_stage_checkpoint(path))
    expect = dataclasses.replace(back, lr=torch.tensor(2e-5, device=dev))
    _same_learner_state("stage-2 warm start", expect, ts2)
    obs, state, finite = ts2.last_obs, ts2.env_state, True
    step_s = []
    with torch.no_grad():
        for _ in range(STAGE2_STEPS):
            t0 = time.perf_counter()
            mu, _ = stage2._forward(ts2.params, ts2.obs_norm, obs)
            state, out = stage2_env.step(state, mu)
            obs = out.obs
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(out.obs).all()) \
                and bool(torch.isfinite(out.reward).all())
    if not finite:
        fail("stage-2 warm-started steps not finite")
    k3 = FK.fk_chain.launches
    if k3 != 1 + 2 * STAGE2_STEPS:
        fail(f"K3 launched {k3} times in the warm-started reset and {STAGE2_STEPS} steps, "
             f"expected {1 + 2 * STAGE2_STEPS}")

    dual_ts, times["dual_warm_start_s"] = _timed(lambda: dual_agent.load_stage_checkpoint(path))
    for k, v in back.params.items():
        for lane in range(dual_agent.num_policies):
            _same(f"dual lane {lane} param {k}", dual_ts.params[k][lane].detach(), v.detach())
    for i, m in enumerate(back.opt_state.mu):
        _same(f"dual lane 1 mu[{i}]", dual_ts.opt_state.mu[i][1], m)

    im_path = os.path.join(CKPT_DIR, "imitation.npz")
    _, times["imitation_save_s"] = _timed(lambda: im_agent.save_checkpoint(im_path, im_ts))
    im_back, times["imitation_load_s"] = _timed(lambda: im_agent.load_checkpoint(im_path))
    _same_learner_state("imitation checkpoint", im_ts, im_back)
    if im_back.opt_state.mu[0].dtype != torch.bfloat16:
        fail(f"imitation moments came back as {im_back.opt_state.mu[0].dtype}")

    gen = agent.env.gen
    pool_path = os.path.join(CKPT_DIR, "pool.npz")
    _, times["pool_save_s"] = _timed(lambda: gen.save_npz(pool_path))
    pool, times["pool_load_s"] = _timed(lambda: TennisBallGenerator.from_npz(pool_path,
                                                                              device=dev))
    for name in ("traj_pool", "launch_pos", "launch_vel", "launch_vspin", "x_order"):
        _same(f"ball pool {name}", getattr(pool, name), getattr(gen, name))
    lib_path = os.path.join(CKPT_DIR, "motion_lib.npz")
    _, times["motion_lib_save_s"] = _timed(lambda: lib.save(lib_path))
    lib2, times["motion_lib_load_s"] = _timed(lambda: MotionLib.load(lib_path, device=dev))
    for f in dataclasses.fields(MotionLib):
        _same(f"motion lib {f.name}", getattr(lib2, f.name), getattr(lib, f.name).to(dev))
    sizes = {os.path.basename(p): os.path.getsize(p)
             for p in (path, im_path, pool_path, lib_path)}
    say("ckpt", card=card, nvidia_smi=nvidia_smi(), stage2_envs=STAGE2_ENVS,
        stage2_steps=STAGE2_STEPS, stage2_k3_launches=k3,
        stage2_ms_per_step=[s * 1e3 for s in step_s], dual_policies=dual_agent.num_policies,
        bytes=sizes, pool=gen.pool_size, motion_lib_frames=int(lib.gts.shape[0]),
        imitation_moments=str(im_back.opt_state.mu[0].dtype), finite=finite,
        all_finite=all(math.isfinite(v) for v in times.values()), **times)
    return {"fk_chain": k3}


def _mvae_small(device, seed=0):
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset

    opt = MVAEOption(latent_size=8, hidden_size=64, num_experts=3, nframes_seq=6, batch_size=8,
                     predict_phase=True, curriculum_schedule=(0.0, 0.25),
                     mixed_phase_schedule=((0.0, 1.0), (0.5, 0.1)), softmax_future=True,
                     n_epochs=4, n_epochs_decay=4, lr=3e-4,
                     checkpoint_dir=os.path.join(CKPT_DIR, f"mvae_small_{device}"), seed=seed)
    return MVAETrainer(opt, make_synthetic_pose_dataset(opt, num_seqs=3, T=60, seed=0),
                       device=device)


def mvae_parity_phase(dev):
    """Two small MVAE epochs (2 windows of 5 optimizer steps) on the card
    against the CPU with the same reparameterization draws, within the CPU
    test's bounds against the JAX trainer: losses 1e-5 relative, params
    2·steps·lr elementwise, the update 1e-3 of its norm."""
    import numpy as np

    gpu, cpu = _mvae_small(dev), _mvae_small("cpu")
    p0 = [p.detach().clone() for p in cpu.params]
    rng = np.random.default_rng(1)
    losses, steps = [], 0
    for _ in range(2):
        eps = rng.standard_normal((2, 5, 8, 8)).astype(np.float32)
        lg = gpu.train_epoch(batches_per_epoch=2, draws={"eps": eps})
        lc = cpu.train_epoch(batches_per_epoch=2, draws={"eps": eps})
        steps += 10
        for k in lc:
            if not abs(lg[k] - lc[k]) <= 1e-5 * abs(lc[k]) + 1e-7:
                fail(f"MVAE parity: loss {k} {lg[k]} on the card, {lc[k]} on the CPU")
        losses.append({"card": lg, "cpu": lc})
    err, upd = 0.0, 0.0
    for a, b, b0 in zip(gpu.params, cpu.params, p0):
        a, b = a.detach().cpu(), b.detach()
        err = max(err, float((a - b).abs().max()))
        rel = float((a - b).norm()) / max(float((b - b0).norm()), 1e-12)
        upd = max(upd, rel)
    if not err <= 2 * steps * gpu.opt.lr or not upd <= 1e-3:
        fail(f"MVAE parity: params differ by {err} (bound {2 * steps * gpu.opt.lr}), update by "
             f"{upd} of its norm")
    say("mvae_parity", steps=steps, params_max_abs_err=err, update_rel_err=upd, losses=losses)


def _mvae_step_split(trainer, feat, phase, reps: int = 20):
    """Device time of one optimizer step's forward (with the loss), backward
    and Adam at the trainer's batch, each timed alone with CUDA events over
    `reps` runs; Adam on copies of the params and moments."""
    import torch

    from vid2player3d_torch.learn.optim import AdamState, adam_apply

    B = feat.shape[0]
    cond, gt, gp = feat[:, :1], feat[:, 1:2], phase[:, 1:2]
    eps = torch.randn(B, trainer.opt.latent_size, device=feat.device)
    lr = torch.tensor(trainer.opt.lr, device=feat.device)
    total, _, _ = trainer.loss(cond, gt, gp, eps, 10.0)
    grads = torch.autograd.grad(total, trainer.params)
    params = [p.detach().clone() for p in trainer.params]
    st = trainer.opt_state
    state = AdamState(count=st.count.clone(), mu=[m.clone() for m in st.mu],
                      nu=[v.clone() for v in st.nu])

    def backward():
        t, _, _ = trainer.loss(cond, gt, gp, eps, 10.0)
        torch.autograd.grad(t, trainer.params)

    forward_ms = cuda_ms(lambda: trainer.loss(cond, gt, gp, eps, 10.0), reps)
    return dict(forward_ms=forward_ms,
                backward_ms=cuda_ms(backward, reps) - forward_ms,
                adam_ms=cuda_ms(lambda: adam_apply(params, state, grads, lr), reps))


def _k2_b100(dev, card: str, gen):
    """K2 at the trainer's batch (B = 100): on the decoder's three layers,
    the forward held to its plain version (1e-4 relative, as phase 4) and
    the backward to autograd of the plain forward (1e-3 relative), then on
    the same inputs one forward eager and as a graph, its bound, the cuBLAS
    yardstick, and the backward (the plain `_moe_bwd`)."""
    import torch

    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    tol = 1e-4
    layers = [_moe_layer_inputs(dev, MVAE_BATCH, d_in, d_out, gen) for d_in, d_out in MOE_LAYERS]
    gs = [torch.randn(MVAE_BATCH, d_out, generator=gen, device=dev) for _, d_out in MOE_LAYERS]
    err = 0.0
    for a in layers:
        want = MOE.moe_linear_ref(*a)
        e = float((MOE.moe_linear(*a) - want).abs().max())
        err = max(err, e)
        if not e <= tol * max(1.0, float(want.abs().max())):
            fail(f"K2 disagrees with its plain version at B={MVAE_BATCH} "
                 f"{a[0].shape[1]}x{want.shape[1]}: {e}")
    bwd_err = max(_k2_backward_err(MOE, a, g) for a, g in zip(layers, gs))
    times = _k2_times(dev, card, MVAE_BATCH, gen, layers)
    bwd = lambda: [MOE._moe_bwd(*a, g) for a, g in zip(layers, gs)]  # noqa: E731
    keep = ("ms", "graph_ms", "plain_ms", "plain_graph_ms", "library_ms", "library_graph_ms",
            "split_ms", "split_graph_ms", "bound_ms", "bound_by", "f32_simt_bound_ms",
            "split_bound_ms", "share_of_3xtf32_bound", "achieved_tflops")
    return dict({k: times[k] for k in keep}, max_abs_err=err, tol=tol,
                backward_max_abs_err=bwd_err, backward_ms=cuda_ms(bwd, KERNEL_TIMED),
                backward_graph_ms=_graph_ms(bwd, KERNEL_TIMED))


def mvae_main_phase(dev, card: str, tennis_agent, tennis_ts):
    """mvae_federer at full width (frame 288 -> 290 outputs, latent 32,
    hidden 256, 6 experts, batch 100, 10-frame windows: 9 optimizer steps
    each) on a synthetic pose dataset, 2 epochs x 50 windows from epoch 75;
    K2's counters set to 0 just before and read just after (3 prep + 3 GEMM
    per optimizer step); then save -> a fresh trainer's load -> the spec ->
    the random-walk report, and 8 TennisEnv steps at federer_train_stage_1's
    10,240 envs driven by the trained spec."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.envs import TennisConfig, TennisEnv
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset
    from vid2player3d_torch.mvae.eval import report_for_trainer
    from vid2player3d_torch.ops import fk as FK
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")
    from vid2player3d_torch.tennis import player as P

    t0 = time.perf_counter()
    opt = MVAEOption.load("federer")
    if opt.batch_size != MVAE_BATCH:
        fail(f"mvae_federer's batch is {opt.batch_size}; K2 was checked at {MVAE_BATCH}")
    opt.checkpoint_dir = os.path.join(CKPT_DIR, "mvae")
    ds = make_synthetic_pose_dataset(opt, num_seqs=64, T=300, seed=0)
    trainer = MVAETrainer(opt, ds, device=dev)
    trainer.epoch = MVAE_START_EPOCH
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    nsteps = opt.nframes_seq - opt.num_future_predictions - opt.num_condition_frames + 1

    regs = []
    regressive = trainer._regressive
    trainer._regressive = lambda e: regs.append(regressive(e)) or regs[-1]
    torch.cuda.reset_peak_memory_stats()
    MOE.moe_linear.launches = MOE.split_weights.launches = 0
    epoch_s, rows = [], []
    for _ in range(MVAE_EPOCHS):
        t0 = time.perf_counter()
        rows.append(trainer.train_epoch(batches_per_epoch=MVAE_BATCHES))
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    k2, k2_prep = MOE.moe_linear.launches, MOE.split_weights.launches
    del trainer._regressive
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = MVAE_EPOCHS * MVAE_BATCHES * nsteps
    if k2 != 3 * steps or k2_prep != 3 * steps:
        fail(f"K2 launched {k2} GEMMs and {k2_prep} preps in MVAE training, expected "
             f"{3 * steps} each")
    if int(trainer.opt_state.count) != steps:
        fail(f"MVAE optimizer count {int(trainer.opt_state.count)}, expected {steps}")
    for i, r in enumerate(rows):
        if not all(math.isfinite(v) for v in r.values()):
            fail(f"MVAE epoch {i}: non-finite losses {r}")

    # where an optimizer step's time goes, and the device's idle share over
    # one window (launch counts restored: these are not the main path's)
    feat, phase = ds.sample_batch(opt.batch_size)
    feat = torch.as_tensor(feat, dtype=torch.float32, device=dev)
    phase = torch.as_tensor(phase, dtype=torch.float32, device=dev)
    split = _mvae_step_split(trainer, feat, phase)
    # one window at lr 0 replayed from the trainer's graph (the main path)
    # and run eagerly, each profiled
    g = trainer._graph
    g.lr.zero_()
    g.feat.copy_(feat)
    g.phase.copy_(phase)
    g.regressive.fill_(0.0)
    g.phase_w.fill_(10.0)
    windows = {}
    for name, fn in (("graph", lambda: g.window(g.window.key)),
                     ("eager", lambda: trainer._window(
                         feat, phase, torch.tensor(False, device=dev), 10.0,
                         torch.tensor(0.0, device=dev)))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        evs = _device_events(prof)
        busy = sum(e.time_range.elapsed_us() for e in evs) * 1e-6
        k2_busy = sum(e.time_range.elapsed_us() for e in evs
                      if "moe_linear_kernel" in e.name or "moe_split_w_kernel" in e.name) * 1e-6
        windows[name] = dict(
            wall_s=window_s, device_busy_s=busy,
            device_idle_share=(1.0 - busy / window_s) if evs else "not measured",
            k2_device_share=k2_busy / busy if busy else "not measured",
            device_events=len(evs))
    k2_b100 = _k2_b100(dev, card, torch.Generator(device=dev).manual_seed(5))
    MOE.moe_linear.launches, MOE.split_weights.launches = k2, k2_prep

    # save -> a fresh trainer's load -> the spec -> the random-walk report
    _, save_s = _timed(trainer.save_checkpoint)
    fresh = MVAETrainer(opt, make_synthetic_pose_dataset(opt, num_seqs=4, T=120, seed=1),
                        device=dev)
    _, load_s = _timed(fresh.load_checkpoint)
    for a, b in zip(fresh.params, trainer.params):
        _same("MVAE checkpoint param", a.detach(), b.detach())
    if not np.array_equal(fresh.dataset.std, trainer.dataset.std):
        fail("MVAE checkpoint: std differs")
    MOE.moe_linear.launches = MOE.split_weights.launches = 0
    report, report_s = _timed(lambda: report_for_trainer(
        fresh, num_steps=MVAE_REPORT_STEPS, num_envs=MVAE_REPORT_ENVS))
    report_k2 = (MOE.moe_linear.launches, MOE.split_weights.launches)
    if report_k2 != (3 * MVAE_REPORT_STEPS, 3 * MVAE_REPORT_STEPS):
        fail(f"K2 launched {report_k2} in the {MVAE_REPORT_STEPS}-step random walk")
    if not report["finite"] or not all(math.isfinite(v) for v in report.values()):
        fail(f"MVAE random-walk report not finite: {report}")

    # the trained spec drives federer_train_stage_1's env, from the
    # checkpoint's own init frames
    spec = P.spec_from_trainer(fresh)
    init = np.load(os.path.join(fresh.checkpoint_dir(), "init_frames.npy"))
    src = tennis_agent.env
    env = TennisEnv(src.cfg, spec, init, ball_generator=src.gen, pi_low=src.pi_low, device=dev)
    state, obs = env.reset_all()
    MOE.moe_linear.launches = MOE.split_weights.launches = FK.fk_chain.launches = 0
    step_s, finite = [], True
    with torch.no_grad():
        for _ in range(MVAE_TENNIS_STEPS):
            t0 = time.perf_counter()
            mu, _ = tennis_agent._forward(tennis_ts.params, tennis_ts.obs_norm, obs)
            state, out = env.step(state, mu)
            obs = out.obs
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(out.obs).all())
    tennis_k = (MOE.moe_linear.launches, MOE.split_weights.launches, FK.fk_chain.launches)
    if tennis_k != (3 * MVAE_TENNIS_STEPS, 3 * MVAE_TENNIS_STEPS, 2 * MVAE_TENNIS_STEPS):
        fail(f"the trained spec's tennis steps launched K2/prep/K3 {tennis_k}")
    if not finite:
        fail("tennis steps driven by the trained MVAE not finite")
    MOE.moe_linear.launches, MOE.split_weights.launches = k2, k2_prep

    nbytes = {n: os.path.getsize(os.path.join(fresh.checkpoint_dir(), n))
              for n in ("latest.npz", "avg.npy", "std.npy", "init_frames.npy")}
    say("mvae_main", card=card, nvidia_smi=nvidia_smi(), config="mvae_federer",
        widths="frame 288 -> 290 outputs, latent 32, hidden 256, 6 experts",
        batch=opt.batch_size, nframes_seq=opt.nframes_seq, optimizer_steps_per_window=nsteps,
        epochs=MVAE_EPOCHS, windows_per_epoch=MVAE_BATCHES, start_epoch=MVAE_START_EPOCH,
        cut=f"{MVAE_EPOCHS} epochs x {MVAE_BATCHES} windows of the config's 500 x 500",
        dataset_frames=int(ds.feature_arr.shape[0]), regressive_windows=int(sum(regs)),
        setup_s=setup_s, epoch_s=epoch_s,
        optimizer_steps_per_s=[MVAE_BATCHES * nsteps / e for e in epoch_s],
        ms_per_optimizer_step=[e / (MVAE_BATCHES * nsteps) * 1e3 for e in epoch_s],
        step_split_device_ms=split, window=windows, k2_launches=k2, k2_prep_launches=k2_prep,
        peak_mem_gib=peak_gib, losses=rows, k2_B100=k2_b100, save_s=save_s, load_s=load_s,
        checkpoint_bytes=nbytes, report_s=report_s, report_steps=MVAE_REPORT_STEPS,
        report_envs=MVAE_REPORT_ENVS, report_k2_launches=report_k2[0], report=report,
        tennis_envs=env.cfg.num_envs, tennis_steps=MVAE_TENNIS_STEPS,
        tennis_ms_per_step=[s * 1e3 for s in step_s],
        tennis_k2_k2prep_k3_launches=list(tennis_k))
    return {"moe_linear": k2, "moe_split_w": k2_prep}, k2_b100


# ---------------------------------------------------------------------------
# phase 22 (tennis and dual parts): where a rollout's time goes
# ---------------------------------------------------------------------------

def rollout_profile_phase(name: str, card: str, agent, ts, horizon: int = 2):
    """A rollout of `horizon` steps at a main path's sizes, profiled after
    that path's warm-up: device busy and idle share, device events per env
    step, the costliest kernels, K2's and K3's device share, and per span of
    SPANS its device time in the step graph's replays and its share of the
    device's busy time, from the port's tracer (on for this rollout, its
    graph captured with the stamps)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.utils import trace

    short = dataclasses.replace(agent.cfg, horizon=horizon)
    cfg0 = agent.cfg
    agent.cfg = short
    graphed = getattr(agent, "graphed", False)
    trace.tracer.enable(True)
    try:
        if graphed:
            agent.rollout(ts)      # the short horizon's step graph, captured before the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with trace.tracer.epoch(-1, agent.device):
                agent.rollout(ts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        agent.cfg = cfg0
        trace.tracer.enable(False)
    rep = trace.tracer.report()[-1]
    parts = rep.get("graphs", {}).get("step", {}).get("parts", {}) \
        if rep["parts_clock"] == "device" else {}
    evs = _device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in evs) * 1e-6
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    k2_s = sum(v for k, v in by_name.items()
               if "moe_linear_kernel" in k or "moe_split_w_kernel" in k)
    k3_s = sum(v for k, v in by_name.items() if "fk_chain_kernel" in k)
    spans = {}
    for span in SPANS:
        p = parts.get(span)
        spans[span] = dict(
            device_ms_per_step=p["per_replay_ms"] if p else "not measured",
            device_share=p["total_ms"] * 1e-3 / busy if p and busy else "not measured")
    say(name, card=card, envs=agent.env.cfg.num_envs, horizon=horizon, graphed=graphed,
        wall_s=wall,
        wall_s_per_env_step=wall / horizon,
        device_busy_s=busy if evs else "not measured",
        device_idle_share=(1.0 - busy / wall) if evs else "not measured",
        device_events_per_env_step=len(evs) / horizon,
        k2_device_share=k2_s / busy if busy else "not measured",
        k3_device_share=k3_s / busy if busy else "not measured",
        spans=spans, top_device_s={k[:60]: v for k, v in top})


# ---------------------------------------------------------------------------
# phase 21: the command line
# ---------------------------------------------------------------------------

# the evaluation runs' env counts (the step is bound by the host issuing
# kernels, so its wall barely depends on N); even for the dual rally
CLI_EVAL_ENVS, CLI_DUAL_ENVS = 64, 64
EVAL_KEYS = {"cycles", "hit_rate", "bounce_in_rate", "bounce_pos_error", "fh_ratio",
             "reward_mean"}


def _cli_call(argv):
    """`cli.run.main(argv)` in this process: (console text, seconds)."""
    import contextlib
    import io

    import torch

    from vid2player3d_torch.cli.run import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {' '.join(argv)}: exit {rc}")
    return buf.getvalue(), secs


def _json_block(text: str):
    """The first JSON object the CLI printed (its indented report)."""
    start = text.index("{")
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return json.loads(text[start:i + 1])
    fail("cli: unterminated report")


def _check_report(what, rep, lanes=()):
    import math

    if set(rep) != EVAL_KEYS | set(lanes):
        fail(f"{what}: report keys {sorted(rep)}")
    for k, v in list(rep.items()) + [(f"{ln}.{k}", v) for ln in lanes
                                     for k, v in rep[ln].items()]:
        if isinstance(v, dict):
            continue
        if v is not None and not math.isfinite(v):
            fail(f"{what}: {k} = {v}")


def _cli_subprocess(argv, timed=False):
    """`python -m vid2player3d_torch argv` started in a process of its own
    (the card by default, no --device); with `timed`, the same entry point
    through `timed_cli`, which prints each evaluation rollout's seconds;
    (process, start time)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = ["-c", "import sys, chip_smoke as C; sys.exit(C.timed_cli(sys.argv[1:]))"] if timed \
        else ["-m", "vid2player3d_torch"]
    return (subprocess.Popen([sys.executable, *cmd, *argv], cwd=REPO,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def _cli_wait(what, started, timeout=900):
    """Wait for a `_cli_subprocess`; (its stdout, its wall seconds)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"cli {what}: no exit within {timeout} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli {what}: exit {proc.returncode}\n{out[-3000:]}{err[-3000:]}")
    return out, secs


def cli_phase(dev, card: str):
    """The README's curriculum through the port's entry points, into a
    directory under build/. `python -m vid2player3d_torch --cfg
    mvae_federer` runs as a process of its own while federer_im trains at
    4096 envs in this one; federer_train_stage_1 at its own 10,240 envs
    must find both, with K2's and K3's counters set to 0 just before the
    call and read just after, the epoch's share and the rest of the call
    apart. Then nadal_federer's eval with --render runs as a process of its
    own while this one evaluates stage 1 with --render and --select_best
    from its best.npz and runs the pool CLI with the native and the torch
    backends at 100,000 candidates, both files loaded on the card. Each
    evaluation rollout is timed around the path it takes (each step a graph
    replay on the card), the dual process's as it prints them; every
    record set and shape is captured once."""
    import shutil

    import numpy as np
    import torch

    from vid2player3d_torch.cli.configs import get_config
    from vid2player3d_torch.learn import V2PPPO
    from vid2player3d_torch.ops import fk as FK
    from vid2player3d_torch.ops import fused_adam as FA
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")
    from vid2player3d_torch.tennis import pool as POOL
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    def counts():
        return {"moe_linear": MOE.moe_linear.launches, "moe_split_w": MOE.split_weights.launches,
                "fk_chain": FK.fk_chain.launches}

    D = os.path.join(REPO, "build", f"cli_smoke_{os.getpid()}")
    shutil.rmtree(D, ignore_errors=True)
    os.makedirs(D)
    out = {}
    t_phase = time.perf_counter()
    procs = []
    try:
        # 1. the MotionVAE at full width through `python -m`, beside 2.
        mvae = _cli_subprocess(["--cfg", "mvae_federer", "--epochs", "1", "--mvae_batches",
                                "20", "--out", D])
        procs.append(mvae[0])

        # 2. the player's imitation policy at bench.py's env count
        FA.leaf_update.launches = FA.global_norm_scalars.launches = 0
        im_dir = os.path.join(D, "federer_im")
        _, out["federer_im_s"] = _cli_call(["--cfg", "federer_im", "--num_envs", str(NUM_ENVS),
                                            "--epochs", "1", "--out", im_dir])
        for f in ("best.npz", "latest.npz", "metrics.jsonl"):
            if not os.path.exists(os.path.join(im_dir, f)):
                fail(f"cli federer_im: no {f}")
        row = json.loads(open(os.path.join(im_dir, "metrics.jsonl")).readlines()[-1])
        out["federer_im_metrics"] = {k: row[k] for k in ("reward_mean", "alive_ratio", "kl")}
        # `fused_optimizer="auto"` takes K1 on the card: one norm and one
        # update per optimizer step
        ppo = get_config("federer_im").ppo
        steps = ppo.mini_epochs * NUM_ENVS * ppo.horizon // ppo.minibatch_size
        out["federer_im_k1_launches"] = [FA.leaf_update.launches, FA.global_norm_scalars.launches]
        if out["federer_im_k1_launches"] != [steps, steps]:
            fail(f"cli federer_im: K1 launched {out['federer_im_k1_launches']} times, "
                 f"expected {steps} each")

        text, out["mvae_subprocess_s"] = _cli_wait("mvae_federer", mvae)
        mvae_rep = _json_block(text)
        if mvae_rep.get("finite") is not True:
            fail(f"cli mvae_federer: random-walk report {mvae_rep}")
        for f in ("latest.npz", "init_frames.npy", "avg.npy", "std.npy"):
            if not os.path.exists(os.path.join(D, "mvae_federer", f)):
                fail(f"cli mvae_federer: no {f}")
        out["mvae_report"] = mvae_rep

        # 3. stage 1 at its own sizes, alone on the card; the epoch's
        # launches apart from the rest of the call
        epoch_counts, epoch_s, save_s = [], [], []
        orig_epoch, orig_save = V2PPPO.train_epoch, V2PPPO.save_checkpoint

        def counted_epoch(self, ts, draws=None):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            res = orig_epoch(self, ts, draws)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            epoch_counts.append({k: v - c0[k] for k, v in counts().items()})
            return res

        def timed_save(self, path, ts):
            t0 = time.perf_counter()
            orig_save(self, path, ts)
            save_s.append(time.perf_counter() - t0)

        V2PPPO.train_epoch, V2PPPO.save_checkpoint = counted_epoch, timed_save
        try:
            MOE.moe_linear.launches = MOE.split_weights.launches = FK.fk_chain.launches = 0
            text, out["stage1_s"] = _cli_call(["--cfg", "federer_train_stage_1", "--epochs", "1",
                                               "--out", D])
            total = counts()
        finally:
            V2PPPO.train_epoch, V2PPPO.save_checkpoint = orig_epoch, orig_save
        want_pi = f"embedding frozen low-level policy from {im_dir}/best.npz"
        if want_pi not in text or "no trained MVAE" in text:
            fail("cli stage 1 did not find federer_im/best.npz and the trained MotionVAE:\n"
                 + text[-2000:])
        steps = TENNIS_HORIZON
        want = {"moe_linear": 3 * steps, "moe_split_w": 3 * steps, "fk_chain": 2 * steps}
        if epoch_counts != [want]:
            fail(f"cli stage 1: the epoch launched {epoch_counts}, expected {want}")
        rest = {k: total[k] - want[k] for k in total}
        # the rest of the call: init_state's reset of every env (one FK)
        if rest != {"moe_linear": 0, "moe_split_w": 0, "fk_chain": 1}:
            fail(f"cli stage 1: {rest} launches outside the epoch")
        row = json.loads(open(os.path.join(D, "metrics.jsonl")).readlines()[-1])
        if row["grad_skip"] != 0.0:
            fail(f"cli stage 1: grad_skip {row['grad_skip']}")
        out.update(stage1_epoch_launches=epoch_counts[0], stage1_rest_launches=rest,
                   stage1_epoch_s=epoch_s[0], stage1_save_s=save_s,
                   stage1_metrics={k: row[k] for k in ("reward_mean", "grad_skip", "kl",
                                                      "racket_ball_dist", "cycles")})

        # 4. the dual rally's evaluation in a process of its own, beside the
        # stage's evaluation and the pools; each process times its rollouts
        # around the path taken (graphed on the card)
        dual_html = os.path.join(D, "dual.html")
        dual = _cli_subprocess(["--cfg", "nadal_federer", "--num_envs", str(CLI_DUAL_ENVS),
                                "--test", "--epochs", "1", "--render", dual_html, "--out", D],
                               timed=True)
        procs.append(dual[0])
        rollouts = []
        undo = _eval_timer(rollouts)
        try:
            html = os.path.join(D, "roll.html")
            text, out["eval_s"] = _cli_call(
                ["--cfg", "federer_train_stage_1", "--num_envs", str(CLI_EVAL_ENVS), "--test",
                 "--epochs", "1", "--render", html, "--select_best", "--out", D,
                 "--checkpoint", os.path.join(D, "best.npz")])
        finally:
            undo()
        rep = _json_block(text)
        _check_report("cli eval", rep)
        _check_eval_rollouts("cli eval", rollouts)
        ids = json.loads(text.split("select_best env ids: ")[1].splitlines()[0])
        page = open(html).read() if os.path.exists(html) else ""
        if f'"envs": {json.dumps(ids)}' not in page or len(ids) != 4:
            fail(f"cli eval: {html} does not hold the selected envs {ids}")
        out.update(eval_report=rep, select_best=ids, eval_rollouts=rollouts)

        # 5. the pool CLI, both backends, and the two files on the card
        pools = {}
        for backend in ("native", "torch"):
            path = os.path.join(D, f"pool_{backend}.npz")
            t0 = time.perf_counter()
            POOL.main(["--out", path, "--backend", backend])
            torch.cuda.synchronize()
            out[f"pool_{backend}_s"] = time.perf_counter() - t0
            pools[backend] = TennisBallGenerator.from_npz(path, device=dev)
        nat, tor = pools["native"], pools["torch"]
        if not nat.traj_pool.is_cuda or abs(nat.pool_size - tor.pool_size) > 0.05 * tor.pool_size:
            fail(f"cli pools: {nat.pool_size} native against {tor.pool_size} torch")
        # the common survivors, matched by their launch positions' bits
        where = {r.tobytes(): k for k, r in enumerate(tor.launch_pos.cpu().numpy())}
        pairs = [(k, where[r.tobytes()]) for k, r in enumerate(nat.launch_pos.cpu().numpy())
                 if r.tobytes() in where]
        i, j = (torch.tensor(x, dtype=torch.long, device=dev) for x in zip(*pairs))
        if i.numel() < 0.95 * min(nat.pool_size, tor.pool_size) \
                or not torch.equal(nat.launch_vel[i], tor.launch_vel[j]) \
                or not torch.equal(nat.launch_vspin[i], tor.launch_vspin[j]):
            fail("cli pools: the common survivors' launch states differ")
        out.update(pool_sizes={"native": nat.pool_size, "torch": tor.pool_size},
                   pool_common=int(i.numel()),
                   pool_traj_max_abs_diff=float((nat.traj_pool[i] - tor.traj_pool[j])
                                                .abs().max()))

        text, out["dual_eval_wall_s"] = _cli_wait("nadal_federer --test", dual)
        dual_rep = _json_block(text)
        dual_rolls = json.loads(text.split("eval_rollouts: ")[1].splitlines()[0])
        _check_eval_rollouts("cli dual eval", dual_rolls)
        _check_report("cli dual eval", dual_rep, lanes=("lane_a", "lane_b"))
        page = open(dual_html).read() if os.path.exists(dual_html) else ""
        if '"envs": [0, 2, 4, 6]' not in page:
            fail(f"cli dual eval: {dual_html} does not hold the paired lanes 0, 2, 4, 6")
        roll = np.load(os.path.join(D, "dual.npz"))
        mask = (roll["swing"] == 2) & (roll["phase"] > 2.0) & (roll["phase"] < 5.0)
        # the rollouts' own seconds (64 + 150 steps), the process's start,
        # set-up, reports, refinement and files apart in its wall
        steps = [r for r in dual_rolls if "steps" in r]
        out.update(dual_report=dual_rep, dual_rollouts=dual_rolls,
                   dual_rollout_s=sum(r["s"] for r in steps),
                   dual_s_per_step=sum(r["s"] for r in steps) / sum(r["steps"] for r in steps),
                   dual_refinement_s=sum(r.get("refinement_pass_s", 0.0) for r in dual_rolls),
                   dual_two_hand_frames=int(mask[:, 0::2].sum()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(D, ignore_errors=True)
    say("cli", card=card, nvidia_smi=nvidia_smi(), im_envs=NUM_ENVS, stage1_envs=TENNIS_ENVS,
        eval_envs=CLI_EVAL_ENVS, dual_eval_envs=CLI_DUAL_ENVS,
        phase_s=time.perf_counter() - t_phase, **out)
    return out["stage1_epoch_launches"]


# ---------------------------------------------------------------------------
# slice 13: the evaluation rollouts replayed from CUDA graphs
# ---------------------------------------------------------------------------

EVAL_SMALL_ENVS = CLI_EVAL_ENVS      # the command line's evaluations
# at 64 envs, cut from 16 and 8 steps, then from 8 and 4, to keep the
# script inside its time limit (each runs eagerly twice: the dual step
# ~1.8-2.6 s)
EVAL_STAGE1_STEPS, EVAL_DUAL_STEPS = 4, 2
EVAL_FULL_STAGE1_STEPS, EVAL_FULL_DUAL_STEPS = 64, 16
WALK_ENVS, WALK_STEPS = 8, 120       # the MotionVAE report's envs; mvae_main's walk
# K2 (prep, GEMM) and K3 per evaluation step, as the training steps launch them
EVAL_STAGE1_LAUNCHES = {"k2_prep": 3, "k2_gemm": 3, "k3": 2}
EVAL_DUAL_LAUNCHES = {"k2_prep": 6, "k2_gemm": 6, "k3": 2}
WALK_LAUNCHES = {"k2_prep": 3, "k2_gemm": 3, "k3": 0}


def _eval_timer(rollouts):
    """Wrap `eval._tennis_rollout` (the dispatcher every tennis evaluation
    and export calls: the path taken, graphed or eager, inside it) and the
    export's post-hoc two-hand refinement; each rollout appends its key,
    steps, envs, synchronized seconds, the path, its record set and its
    graph's captures and stats, each refinement pass its seconds. Returns
    the function that undoes the wrapping."""
    import torch

    from vid2player3d_torch import eval as EV
    from vid2player3d_torch.tennis import twohand as TH

    orig_roll, orig_ik = EV._tennis_rollout, TH.optimize_two_hand_backhand
    inside = [False]

    def timed_roll(agent, ts, seed, num_steps, draws, record):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inside[0] = True
        try:
            res = orig_roll(agent, ts, seed, num_steps, draws, record)
        finally:
            inside[0] = False
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        st = agent._eval_st.get(record) if agent.graphed else None
        rollouts.append(dict(key=seed, record=record.__name__, steps=num_steps,
                             envs=agent.env.cfg.num_envs, s=s, s_per_step=s / num_steps,
                             graphed=agent.graphed,
                             graph=None if st is None else _graph_stats(st.step)))
        return res

    def timed_ik(*args, **kw):
        if inside[0]:                         # the step's own IK (inside a graph)
            return orig_ik(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_ik(*args, **kw)
        torch.cuda.synchronize()
        rollouts.append(dict(refinement_pass_s=time.perf_counter() - t0,
                             iters=kw.get("iters")))
        return out

    EV._tennis_rollout, TH.optimize_two_hand_backhand = timed_roll, timed_ik

    def undo():
        EV._tennis_rollout, TH.optimize_two_hand_backhand = orig_roll, orig_ik
    return undo


def timed_cli(argv) -> int:
    """`cli.run.main(argv)` with every tennis evaluation rollout timed
    (`_eval_timer`), printed after the call as one line `eval_rollouts:
    [...]`: the process of its own that runs the dual evaluation."""
    from vid2player3d_torch.cli.run import main as cli_main

    rollouts = []
    undo = _eval_timer(rollouts)
    try:
        rc = cli_main(argv)
    finally:
        undo()
    print("eval_rollouts: " + json.dumps(rollouts), flush=True)
    return rc


def _check_eval_rollouts(what, rollouts):
    """Every rollout graphed, each record set and shape captured once (a
    repeated record set replays)."""
    rolls = [r for r in rollouts if "steps" in r]
    if not rolls or not all(r["graphed"] and r["graph"]["captures"] == 1 for r in rolls):
        fail(f"{what}: an evaluation rollout did not replay one capture per record set and "
             f"shape: {rolls}")


def _timed_call(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _records_differ(a, b) -> list:
    """The record names whose arrays are not equal to the bit."""
    return sorted(k for k in a if a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes())


def _per_step_launches(what, counts, reset, steps, want) -> dict:
    got = {k: (counts[k] - reset[k]) / steps for k in want}
    if got != want:
        fail(f"{what}: launches per step through the replays {got}, expected {want}")
    return got


def _tennis_eval_case(what, agent, ts, steps, want, eager=True, deterministic=True):
    """`eval_tennis`'s record set from key 4321: the graphed rollout (its
    capture; K2/K3 launches per step through the replays, the eager
    reset's apart, against `want`), again (replays only), and eagerly,
    timed; then under deterministic algorithms, the graphs made anew in
    that mode, eager and graphed again, compared bit for bit."""
    import torch

    from vid2player3d_torch import eval as EV

    rec = EV._tennis_eval_record
    agent._eval_st.clear()
    _zero_kernel_counts()
    with torch.no_grad():
        EV._seeded(agent.env, 4321).reset_all()
    reset = _kernel_counts()
    _zero_kernel_counts()
    first, first_s = _timed_call(lambda: EV._tennis_rollout_graphed(agent, ts, 4321, steps,
                                                                    None, rec))
    out = dict(envs=agent.env.cfg.num_envs, steps=steps, first_graphed_s=first_s,
               launches_per_step=_per_step_launches(what, _kernel_counts(), reset, steps, want),
               reset_launches={k: reset[k] for k in want})
    again, again_s = _timed_call(lambda: EV._tennis_rollout_graphed(agent, ts, 4321, steps,
                                                                   None, rec))
    st = agent._eval_st[rec]
    if st.step.captures != 1:
        fail(f"{what}: the repeated record set captured {st.step.captures} times")
    out.update(graphed_s=again_s, graphed_s_per_step=again_s / steps, graph=_graph_stats(st.step),
               graphed_twice_differ=_records_differ(first[2], again[2]))
    if eager:
        e, e_s = _timed_call(lambda: EV._tennis_rollout_eager(agent, ts, 4321, steps, None, rec))
        out.update(eager_s=e_s, eager_s_per_step=e_s / steps,
                   eager_over_graphed=e_s / again_s,
                   default_mode_differ=_records_differ(e[2], again[2]))
    agent._eval_st.clear()
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            e = EV._tennis_rollout_eager(agent, ts, 4321, steps, None, rec)
            g = EV._tennis_rollout_graphed(agent, ts, 4321, steps, None, rec)
            det_graph = _graph_stats(agent._eval_st[rec].step)
        finally:
            torch.use_deterministic_algorithms(False)
            agent._eval_st.clear()
        differ = _records_differ(e[2], g[2]) + ([] if (e[1] == g[1]).all() else ["tar0"])
        out.update(deterministic_differ=differ, deterministic_graph=det_graph)
        if differ:
            fail(f"{what}: under deterministic algorithms the graphed evaluation differs from "
                 f"the eager one in {differ}")
    return out


def _hold_k2_k3_eval(what, card, env, state, action, k2_batches, k3_ns):
    """K2 and K3 on one eager evaluation step's own inputs, held to their
    plain versions (K2 1e-4 relative, K3 bit for bit); K2's times at each
    batch in `k2_batches` (eager and graph, bound, cuBLAS) and K3's at each
    N in `k3_ns` (eager and graph, bound). The launches are not the path's."""
    from vid2player3d_torch.ops import fk as FK
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    before = _kernel_counts()
    seen = _record_k2_k3(env, state, action)
    out = {}
    for b in k2_batches:
        layers = [seen[f"k2/{mi}/{b}"] for mi in range(len(MOE_LAYERS))]
        err = 0.0
        for a in layers:
            want = MOE.moe_linear_ref(*a)
            e = float((MOE.moe_linear(*a) - want).abs().max())
            err = max(err, e)
            if not e <= 1e-4 * max(1.0, float(want.abs().max())):
                fail(f"{what}: K2 disagrees with its plain version at B={b}: {e}")
        out[f"k2_B{b}"] = dict(_k2_small(card, b, layers), max_abs_err=err, tol=1e-4)
    for n in k3_ns:
        args = seen[f"k3/{n}"]
        err = max(float((a - b).abs().max()) for a, b in zip(FK.fk_chain(*args),
                                                             FK._fk_plain(*args)))
        if err:
            fail(f"{what}: K3 disagrees with its plain version at N={n}: {err}")
        out[f"k3_N{n}"] = dict(_k3_small(card, args), max_abs_err=err, tol=0.0)
    FK.fk_chain.launches, MOE.moe_linear.launches, MOE.split_weights.launches = (
        before["k3"], before["k2_gemm"], before["k2_prep"])
    return out


def _k2_small(card, batch, layers) -> dict:
    keep = ("ms", "graph_ms", "plain_ms", "plain_graph_ms", "library_ms", "library_graph_ms",
            "bound_ms", "bound_by", "share_of_3xtf32_bound")
    t = _k2_times(None, card, batch, None, layers)
    return {k: t[k] for k in keep}


def _k3_small(card, args) -> dict:
    """K3 on one set of inputs (warm: a small N stays in L2 between calls),
    eager and as a graph, its plain version, beside its bound."""
    from vid2player3d_torch.ops import fk as FK

    n = args[0].shape[0]
    nbytes = 4 * (24 * 9 + 24 * 3 + 3 + 24 * 3 + 24 * 9) * n
    flops = n * 23 * (9 * 5 + 3 * 6)
    rate = hbm_rate(card)
    return dict(ms=cuda_ms(lambda: FK.fk_chain(*args), K3_TIMED),
                graph_ms=_graph_ms(lambda: FK.fk_chain(*args), K3_TIMED),
                plain_ms=cuda_ms(lambda: FK._fk_plain(*args), KERNEL_TIMED),
                plain_graph_ms=_graph_ms(lambda: FK._fk_plain(*args)),
                bound_ms=max(nbytes / rate, flops / F32_FLOPS_PER_S) * 1e3, bytes=nbytes,
                bound_by="bytes" if nbytes / rate >= flops / F32_FLOPS_PER_S else "operations",
                library_ms=None)


def _imitation_eval_case(dev, lib):
    """eval_imitation's record set on amass_im at 4096 envs, one context
    segment from the reset of key 1234: graphed and eager, timed; under
    deterministic algorithms both again, bit for bit."""
    import numpy as np
    import torch

    from vid2player3d_torch import eval as EV
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    env = HumanoidImEnv(HumanoidImConfig(num_envs=NUM_ENVS, substeps=SUBSTEPS), lib, rng=0,
                        device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=HORIZON, minibatch_size=MINIBATCH,
                                        mini_epochs=MINI_EPOCHS), seed=7, device=dev)
    ts = agent.init_state()
    if not agent.graphed:
        fail("eval_graphs: the imitation learner does not take the graphs")
    rec, L = EV._im_eval_record, env.cfg.context_length

    def segment(seg):
        s, o, ctx = next(EV._imitation_resets(env, 1234, 1, None))
        return seg(agent, env, ts, s, o, ctx["feat"], L, rec)[2]

    out = dict(envs=NUM_ENVS, steps=L)
    segment(EV._imitation_segment_graphed)               # the capture
    g, g_s = _timed_call(lambda: segment(EV._imitation_segment_graphed))
    e, e_s = _timed_call(lambda: segment(EV._imitation_segment_eager))
    st = agent._eval_st[rec]
    out.update(graphed_s=g_s, graphed_s_per_step=g_s / L, eager_s=e_s, eager_s_per_step=e_s / L,
               eager_over_graphed=e_s / g_s, graph=_graph_stats(st.step),
               alive_ratio=float(g["alive"].mean()),
               default_mode_differ=_records_differ(e, g))
    agent._eval_st.clear()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        e, g = segment(EV._imitation_segment_eager), segment(EV._imitation_segment_graphed)
    finally:
        torch.use_deterministic_algorithms(False)
        agent._eval_st.clear()
    out["deterministic_differ"] = differ = _records_differ(e, g)
    if differ:
        fail(f"eval_graphs: the graphed imitation segment differs from the eager one in {differ}")
    rep = EV.eval_imitation(agent, num_rollouts=1, ts=ts, max_steps=L)
    if not all(np.isfinite(v) for v in rep.values()):
        fail(f"eval_graphs: eval_imitation's report {rep}")
    out["report"] = rep
    return out


def _walk_case(dev, card):
    """The MotionVAE random walk at full width (federer's 256 hidden, 6
    experts), 8 envs, 120 steps from seed 0, as the report after MotionVAE
    training walks: graphed twice, from two spec snapshots (the first call
    captures, the second only replays the kept graph: fails unless it is
    faster than the eager walk and captures nothing), K2 3 + 3 per step
    through the replays, and eager; timed and bit for bit. K2 at B = 8 on
    fresh inputs of the decoder's shapes against its plain version,
    timed."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from vid2player3d_torch.mvae import eval as MVE
    from vid2player3d_torch.tennis import player as P

    spec = P.make_random_spec(0, hidden=256, experts=6, device=dev)
    init = _init_frames()[:WALK_ENVS]
    MVE._WALKS.clear()          # the first call captures (mvae_main's report kept a graph)
    g, first_s = _timed_call(lambda: MVE.random_walk_rollout(spec, init, WALK_STEPS, 0))
    walk = MVE._WALKS[str(dev)]
    # a second report: a new snapshot of the same weights, as each report makes
    again = dataclasses.replace(spec, decoder=copy.deepcopy(spec.decoder))
    _zero_kernel_counts()
    g2, g_s = _timed_call(lambda: MVE.random_walk_rollout(again, init, WALK_STEPS, 0))
    counts = _kernel_counts()
    if MVE._WALKS[str(dev)] is not walk or walk.step.captures != 1:
        fail(f"eval_graphs: the second random walk captured again ({walk.step.captures})")
    launches = _per_step_launches("eval_graphs random walk", counts, {k: 0 for k in counts},
                                  WALK_STEPS, WALK_LAUNCHES)
    e, e_s = _timed_call(lambda: MVE._random_walk_eager(spec, init, WALK_STEPS, 0, 1.0, None))
    differ = [i for i, (a, b, c) in enumerate(zip(e, g, g2))
              if a.tobytes() != b.tobytes() or a.tobytes() != c.tobytes()]
    if differ:
        fail(f"eval_graphs: the graphed random walk differs from the eager one in {differ}")
    if not g_s < e_s:
        fail(f"eval_graphs: the replayed {WALK_STEPS}-step walk took {g_s} s, eager {e_s} s")
    gen = torch.Generator(device=dev).manual_seed(5)
    layers = [_moe_layer_inputs(dev, WALK_ENVS, d_in, d_out, gen) for d_in, d_out in MOE_LAYERS]
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")
    before = _kernel_counts()
    err = 0.0
    for a in layers:
        want = MOE.moe_linear_ref(*a)
        err = max(err, float((MOE.moe_linear(*a) - want).abs().max()))
        if not err <= 1e-4 * max(1.0, float(want.abs().max())):
            fail(f"eval_graphs: K2 disagrees with its plain version at B={WALK_ENVS}: {err}")
    k2 = dict(_k2_small(card, WALK_ENVS, layers), max_abs_err=err,
              tol=1e-4, inputs="fresh, the decoder's layer shapes")
    MOE.moe_linear.launches, MOE.split_weights.launches = before["k2_gemm"], before["k2_prep"]
    return dict(envs=WALK_ENVS, steps=WALK_STEPS, first_graphed_s=first_s, graphed_s=g_s,
                graphed_s_per_step=g_s / WALK_STEPS,
                eager_s=e_s, eager_s_per_step=e_s / WALK_STEPS, eager_over_graphed=e_s / g_s,
                captures=walk.step.captures,
                note="first_graphed_s: the first call, its capture included; graphed_s: the "
                     "second call on a new spec snapshot (its leaves copied into the kept "
                     "statics, every step a replay, the host copy)",
                graph=_graph_stats(walk.step), launches_per_step=launches,
                finite=bool(np.isfinite(g[1]).all()), k2_B8=k2)


def eval_graphs_phase(dev, card: str, stage1_agent, stage1_ts, dual_agent, dual_ts, gen):
    """The evaluation rollouts replayed from CUDA graphs (`eval.py`,
    `mvae/eval.py`), each against its eager body. At the command line's 64
    envs: stage 1 (8 steps) and the nadal_federer dual rally (4 steps),
    graphed (capture, then replays only) and eager, timed, K2/K3 launches
    per step through the replays, bit for bit under deterministic
    algorithms; K2 (B = 64, 32 per dual lane) and K3 (N = 64) on those
    steps' inputs against their plain versions, timed. eval_imitation's
    segment at 4096 envs and the MotionVAE random walk at 8 alike. At full
    width, graphed only: stage 1 at 10,240 envs for 64 steps and the dual
    rally at 15,360 for 16 (the learners of `tennis_main` and
    `dual_main`). Returns the full-width rollouts' K2/K3 launches."""
    import gc

    import torch

    t_phase = time.perf_counter()
    out = {}
    small = _stage1_agent(dev, EVAL_SMALL_ENVS, gen, horizon=16, minibatch=EVAL_SMALL_ENVS,
                          mini_epochs=1)
    ts = small.init_state()
    out["stage1_64"] = _tennis_eval_case("eval_graphs stage 1", small, ts, EVAL_STAGE1_STEPS,
                                         EVAL_STAGE1_LAUNCHES)
    with torch.no_grad():
        mu, _ = small._forward(ts.params, ts.obs_norm, ts.last_obs)
    out["stage1_64"]["kernels"] = _hold_k2_k3_eval("eval_graphs stage 1", card, small.env,
                                                   ts.env_state, mu, (EVAL_SMALL_ENVS,),
                                                   (EVAL_SMALL_ENVS,))
    del small, ts
    dual = _dual_agent(dev, EVAL_SMALL_ENVS, gen, horizon=16, minibatch=EVAL_SMALL_ENVS,
                       mini_epochs=1)
    ts = dual.init_state()
    out["dual_64"] = _tennis_eval_case("eval_graphs dual", dual, ts, EVAL_DUAL_STEPS,
                                       EVAL_DUAL_LAUNCHES)
    with torch.no_grad():
        mu, _ = dual._forward(ts.params, ts.obs_norm, ts.last_obs)
    out["dual_64"]["kernels"] = _hold_k2_k3_eval("eval_graphs dual", card, dual.env,
                                                 ts.env_state, mu, (EVAL_SMALL_ENVS // 2,),
                                                 (EVAL_SMALL_ENVS,))
    del dual, ts
    gc.collect()
    torch.cuda.empty_cache()
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib

    out["imitation_4096"] = _imitation_eval_case(dev, make_synthetic_motion_lib(
        num_motions=8, T=300, fps=30.0, seed=0, device=dev))
    out["random_walk_8"] = _walk_case(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    full = {}
    for name, agent, ts, steps, want in (
            ("stage1_full", stage1_agent, stage1_ts, EVAL_FULL_STAGE1_STEPS, EVAL_STAGE1_LAUNCHES),
            ("dual_full", dual_agent, dual_ts, EVAL_FULL_DUAL_STEPS, EVAL_DUAL_LAUNCHES)):
        out[name] = _tennis_eval_case(f"eval_graphs {name}", agent, ts, steps, want, eager=False,
                                      deterministic=False)
        full[name] = {k: int(v * steps) for k, v in out[name]["launches_per_step"].items()}
        gc.collect()
        torch.cuda.empty_cache()
    say("eval_graphs", card=card, nvidia_smi=nvidia_smi(), phase_s=time.perf_counter() - t_phase,
        unit="s per evaluation step (host clock, synchronized); graphed_s: replays only, the "
             "first call's capture apart (first_graphed_s)", **out)
    return full


# ---------------------------------------------------------------------------
# slice 7: data parallelism over torch.distributed. Two gloo ranks share the
# card (spawned processes); the command line runs NCCL at world size 1.
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMEOUT_S = 300.0
# dp_main: amass_im at 2 x 2048 envs (both sync modes, the horizon cut from
# 32 to 8; the per-minibatch epoch cut from 6 mini-epochs to 1: each of its
# gradient all-reduces takes ~23-34 ms through the host; local SGD cut from 6
# mini-epochs to 2), federer_train_stage_1 at 2 x 2048 with the horizon cut
# from 64 to 8, nadal_federer at 2 x 256 with per-rank minibatches of 1024
# and the horizon cut from 32 to 4: the cuts keep the script inside its time
# limit (every path runs eagerly)
DP_IM_ENVS, DP_TENNIS_ENVS, DP_DUAL_ENVS, DP_DUAL_HORIZON, DP_DUAL_MINIBATCH = \
    4096, 4096, 512, 4, 1024
DP_PER_MINIBATCH_MINI_EPOCHS, DP_LOCAL_SGD_MINI_EPOCHS, DP_TENNIS_HORIZON = 1, 2, 8
DP_IM_HORIZON = 8
DP_KERNELS = ("k1_update", "k1_norm", "k2_prep", "k2_gemm", "k3")


def _kernel_counts() -> dict:
    from vid2player3d_torch.ops import fk as FK
    from vid2player3d_torch.ops import fused_adam as FA
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    return {"k1_update": FA.leaf_update.launches, "k1_norm": FA.global_norm_scalars.launches,
            "k2_prep": MOE.split_weights.launches, "k2_gemm": MOE.moe_linear.launches,
            "k3": FK.fk_chain.launches}


def _zero_kernel_counts() -> None:
    from vid2player3d_torch.ops import fk as FK
    from vid2player3d_torch.ops import fused_adam as FA
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    FA.leaf_update.launches = FA.global_norm_scalars.launches = 0
    MOE.split_weights.launches = MOE.moe_linear.launches = FK.fk_chain.launches = 0


class _KernelRecorder:
    """The first inputs this process's path gave each kernel at each of its
    shapes: the learner's fused step (K1), every MoE layer of the env's
    decoders (K2, by batch) and the env's FK (K3, by env count), cloned once
    so the epoch's time hardly moves; `check` holds each kernel against its
    plain version on them. Installed in a rank process only."""

    def __init__(self):
        import vid2player3d_torch.envs.tennis as TEN
        import vid2player3d_torch.learn.ppo as PPO

        self.last = {}
        k1, fk = PPO.fused_clip_adam_apply, TEN.fk_chain

        def record_k1(params, mu, nu, grads, count, lr, max_norm, *a, **kw):
            if "k1" not in self.last:
                self.last["k1"] = ([p.detach().clone() for p in params],
                                   [m.clone() for m in mu], [v.clone() for v in nu],
                                   [g.detach().clone() for g in grads], count.clone(), lr,
                                   max_norm)
            return k1(params, mu, nu, grads, count, lr, max_norm, *a, **kw)

        def record_fk(rot, off, root_pos, parents):
            key = f"k3/{rot.shape[0]}"
            if key not in self.last:
                self.last[key] = (rot.clone(), off.clone(), root_pos.clone(), tuple(parents))
            return fk(rot, off, root_pos, parents)

        PPO.fused_clip_adam_apply, TEN.fk_chain = record_k1, record_fk

    def watch(self, env) -> None:
        from vid2player3d_torch.mvae.model import MoELayer

        for li, spec in enumerate(getattr(env, "_lane_specs", ())):
            for mi, mod in enumerate(m for m in spec.decoder.modules() if isinstance(m, MoELayer)):
                def hook(module, args, key=f"k2/{li}/{mi}"):
                    coeff, h = args
                    if f"{key}/{h.shape[0]}" not in self.last:
                        self.last[f"{key}/{h.shape[0]}"] = (
                            h.detach().clone(), coeff.detach().clone(), module.w.detach(),
                            module.b.detach())
                mod.register_forward_pre_hook(hook)

    def shapes(self) -> dict:
        """The batches K2 and the env counts K3 were checked at."""
        return {k: sorted({int(key.rsplit("/", 1)[1]) for key in self.last
                           if key.startswith(k + "/")}) for k in ("k2", "k3")}

    def check(self) -> dict:
        """max errors of each kernel against its plain PyTorch version on the
        same inputs, both on the card."""
        import torch

        from vid2player3d_torch.ops import fk as FK
        from vid2player3d_torch.ops import fused_adam as FA
        MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

        errs = {}
        if "k1" in self.last:
            params, mu, nu, grads, count, lr, max_norm = self.last["k1"]
            s_plain, _ = FA.adam_scalars(grads, count, lr, max_norm)
            s_k, _ = FA.global_norm_scalars(grads, count, lr, max_norm)
            errs["k1_scalar_rel"] = float(((s_k - s_plain).abs() / s_plain.abs()).max())
            card = [[t.clone() for t in ts] for ts in (params, mu, nu)]
            plain = [[t.clone() for t in ts] for ts in (params, mu, nu)]
            FA.update_leaves(*card, grads, s_plain)
            for p, m, v, g in zip(*plain, grads):
                FA._leaf_plain(p, m, v, g.contiguous(), s_plain, 0.9, 0.999, 1e-8)
            errs["k1_update"] = max(float((a.float() - b.float()).abs().max())
                                    for ca, pa in zip(card, plain) for a, b in zip(ca, pa))
        k2 = [v for k, v in self.last.items() if k.startswith("k2/")]
        if k2:
            e = 0.0
            for h, coeff, w, b in k2:
                want = MOE.moe_linear_ref(h, coeff, w, b)
                got = MOE.moe_linear(h, coeff, w, b)
                e = max(e, float((got - want).abs().max()) / max(1.0, float(want.abs().max())))
            errs["k2"] = e
        k3 = [v for k, v in self.last.items() if k.startswith("k3/")]
        if k3:
            errs["k3"] = 0.0
            for rot, off, root, parents in k3:
                got = FK.fk_chain(rot, off, root, parents)
                want = FK._fk_plain(rot, off, root, parents)
                errs["k3"] = max([errs["k3"]] + [float((a - b).abs().max())
                                                 for a, b in zip(got, want)])
        torch.cuda.synchronize()
        return errs


def _dp_small_cases(pool):
    """dp_parity's four small cases (f32), each with its global draws: the
    imitation epoch with K1 and a global minibatch; the imitation epoch with
    per-rank minibatches and local SGD; a stage-1 tennis epoch (2 candidate
    resets, episodes of 3 steps, so done envs take candidates across ranks);
    the dual rally with two policies and per-rank minibatches (its two-hand
    lane started in a backhand)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n, t, me, local = 4, 4, 2, 4 * 4 // DP_RANKS

    def perms():
        return np.stack([np.stack([rng.permutation(local) for _ in range(DP_RANKS)])
                         for _ in range(me)])

    cases = {}
    for name, kw in (("im_per_minibatch", dict(minibatch_size=8, fused_optimizer="on")),
                     ("im_local_sgd", dict(minibatch_size=4, minibatch_per_chip=True,
                                           dp_sync="per_mini_epoch"))):
        cases[name] = dict(kind="im", n=n, motion_ids=np.array([0, 1, 1, 0]),
                           ppo=dict(horizon=t, mini_epochs=me, compute_dtype="f32", **kw),
                           draws={"motion_times": (rng.random(n) * 0.8).astype(np.float32),
                                  "noise": rng.standard_normal((t, n, 75)).astype(np.float32),
                                  "perms": perms()})
    arrays = [a.cpu().numpy() for a in (pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                        pool.launch_vspin)]
    for name, dual in (("tennis_stage1", False), ("dual_rally", True)):
        env = dict(num_envs=n, substeps=2, max_episode_length=3 if not dual else 40,
                   reset_reaction_nframes=6, reward_type="reach" if not dual
                   else "return_w_estimate",
                   use_random_ball_target="continuous" if dual else "discrete",
                   reset_candidates=0 if dual else 2)
        learner = dict(horizon=t, mini_epochs=me, actor_units=(64, 32), critic_units=(64, 32),
                       compute_dtype="f32")
        learner.update(dict(minibatch_size=4, minibatch_per_chip=True, num_policies=2) if dual
                       else dict(minibatch_size=8, lr_schedule="adaptive"))
        reset, draws = _tennis_draws(rng, n, t, me, pool.pool_size, env["reset_candidates"],
                                     35, n_init=64, dual=dual)
        draws["perms"] = perms()
        cases[name] = dict(kind="dual" if dual else "tennis", env=env, learner=learner,
                           pool=arrays, reset_draws=reset, draws=draws)
    return cases


def _dp_one_process(case):
    """The one-process counterpart of a dp case: each minibatch the union of
    the shards' minibatches (a per-rank minibatch becomes a global one of
    D times its size); None where no such run exists (local SGD)."""
    import numpy as np

    cfg = case["ppo" if case["kind"] == "im" else "learner"]
    if cfg.get("dp_sync") == "per_mini_epoch":
        return None
    per_chip = cfg.get("minibatch_per_chip", False)
    mb_local = cfg["minibatch_size"] if per_chip else cfg["minibatch_size"] // DP_RANKS
    one = dict(cfg, minibatch_per_chip=False, minibatch_size=mb_local * DP_RANKS)
    perms = []
    for p in case["draws"]["perms"]:
        parts = [(p[r] + r * p.shape[1]).reshape(-1, mb_local) for r in range(DP_RANKS)]
        perms.append(np.concatenate(parts, axis=1).reshape(-1))
    return dict(case, **{"ppo" if case["kind"] == "im" else "learner": one},
                draws=dict(case["draws"], perms=np.stack(perms)))


def _dp_build(dev, case, mesh=None):
    """(learner, train state) of a dp_parity case on `dev`, sharded over
    `mesh` when given."""
    import dataclasses

    import torch

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv, TennisConfig
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig, V2PConfig, V2PPPO
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    if case["kind"] == "im":
        lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=dev)
        env = HumanoidImEnv(HumanoidImConfig(num_envs=case["n"], substeps=2), lib,
                            motion_ids=case["motion_ids"], device=dev)
        env = env.shard(mesh) if mesh is not None else env
        agent = ImitationPPO(env, PPOConfig(**case["ppo"]), seed=7, mesh=mesh, device=dev)
        return agent, agent.init_state()
    gen = TennisBallGenerator.from_arrays(*case["pool"], device=dev)
    make = _dual_env if case["kind"] == "dual" else _tennis_env
    env = make(dev, TennisConfig(**case["env"]), hidden=64, experts=3, gen=gen)
    env = env.shard(mesh) if mesh is not None else env
    agent = V2PPPO(env, V2PConfig(**case["learner"]), seed=7, mesh=mesh, device=dev)
    ts = agent.init_state(reset_draws=case["reset_draws"])
    if case["kind"] == "dual":
        # the two-hand lane starts in a backhand, so the IK runs
        mvae = ts.env_state.mvae
        swing = torch.where(env.two_hand_mask, 2, mvae.swing_type).to(torch.int32)
        ts.env_state = dataclasses.replace(ts.env_state,
                                           mvae=dataclasses.replace(mvae, swing_type=swing))
    return agent, ts


def _dp_epoch(dev, case, mesh=None, recorder=None) -> dict:
    """One epoch of a dp_parity case: metrics, params and moments (on the
    CPU), the step count and the kernels' launches in the epoch."""
    import torch

    agent, ts = _dp_build(dev, case, mesh)
    if recorder is not None:
        recorder.watch(agent.env)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _zero_kernel_counts()
    ts, m = agent.train_epoch(ts, draws=case["draws"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"launches": _kernel_counts(), "metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.detach().cpu() for k, v in ts.params.items()},
            "moments": [t.float().cpu() for t in ts.opt_state.mu + ts.opt_state.nu],
            "count": int(ts.opt_state.count), "steps": agent.num_minibatches}


def _dp_parity_rank(mesh, cases):
    """One rank of dp_parity: each case's epoch on this rank's shard; on the
    card also each kernel against its plain version on this rank's inputs."""
    from vid2player3d_torch import parallel

    # the group's mesh asked for without a device: the card the rank pinned
    out = {"default_device": str(parallel.data_parallel_mesh().device)}
    rec = _KernelRecorder() if mesh.device.type == "cuda" else None
    for name, case in cases.items():
        out[name] = _dp_epoch(mesh.device, case, mesh, rec)
        if rec is not None:
            out[name]["kernel_errs"] = rec.check()
            rec.last.clear()
    return out


def _expected_launches(kind: str, steps: int, horizon: int, fused: bool) -> dict:
    """Each kernel's launches in one epoch on one rank: the world-size-1
    count for the rank's share (K1 two per optimizer step when fused, K2 3
    prep + 3 GEMM per decode, one decode per lane per env step, K3 two per
    env step: the FK targets and the masked reset)."""
    k1 = steps if fused else 0
    decodes = {"im": 0, "tennis": 1, "dual": 2}[kind] * horizon
    return {"k1_update": k1, "k1_norm": k1, "k2_prep": 3 * decodes, "k2_gemm": 3 * decodes,
            "k3": 0 if kind == "im" else 2 * horizon}


def _close(what, got, want, atol, norm_frac, init=None):
    """Params (dicts of CPU tensors) elementwise within `atol` and, as an
    update from `init` (or as values), within `norm_frac` of its norm."""
    diff2 = ref2 = 0.0
    for k, w in want.items():
        g = got[k]
        err = float((g - w).abs().max())
        if not err <= atol:
            fail(f"{what}: {k} off by {err} (atol {atol})")
        diff2 += float(((g - w) ** 2).sum())
        base = w if init is None else w - init[k]
        ref2 += float((base ** 2).sum())
    if not diff2 ** 0.5 <= norm_frac * ref2 ** 0.5:
        fail(f"{what}: update off by {diff2 ** 0.5} of {ref2 ** 0.5}")
    return diff2 ** 0.5 / max(ref2 ** 0.5, 1e-30)


def dp_parity_phase(dev, card: str):
    """dp_parity: two gloo ranks share the card; the same cases at world size
    1 on the card and (local SGD, which has no one-process counterpart) two
    gloo ranks on the CPU."""
    import torch

    from vid2player3d_torch import parallel
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    t0 = time.perf_counter()
    cases = _dp_small_cases(TennisBallGenerator(num_candidates=256, seed=0, device="cpu"))
    ranks = parallel.spawn(_dp_parity_rank, DP_RANKS, args=(cases,), backend="gloo",
                           device=dev, timeout_s=DP_TIMEOUT_S)
    host = parallel.spawn(_dp_parity_rank, DP_RANKS, args=({"im_local_sgd":
                                                            cases["im_local_sgd"]},),
                          device="cpu", timeout_s=DP_TIMEOUT_S)
    if [r["default_device"] for r in ranks] != [str(dev)] * DP_RANKS:
        fail(f"dp_parity: the group's mesh without a device is on "
             f"{[r['default_device'] for r in ranks]}, the ranks pinned {dev}")
    rows = {}
    for name, case in cases.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        for k in r0["params"]:
            if not torch.equal(r0["params"][k], r1["params"][k]):
                fail(f"dp_parity {name}: ranks' params differ at {k}")
        if not all(torch.equal(a, b) for a, b in zip(r0["moments"], r1["moments"])) \
                or r0["count"] != r1["count"]:
            fail(f"dp_parity {name}: ranks' Adam state differs")
        cfg = case["ppo" if case["kind"] == "im" else "learner"]
        want = _expected_launches(case["kind"], cfg["mini_epochs"] * r0["steps"], cfg["horizon"],
                                  cfg.get("fused_optimizer") == "on"
                                  and cfg.get("dp_sync") != "per_mini_epoch")
        for r, out in enumerate((r0, r1)):
            if out["launches"] != want:
                fail(f"dp_parity {name} rank {r}: launches {out['launches']}, expected {want}")
            errs = out["kernel_errs"]
            need = DP_CHECKED[name]
            if set(errs) != set(need) or any(not errs[k] <= DP_HELD[k] for k in errs):
                fail(f"dp_parity {name} rank {r}: kernels against their plain versions {errs}")
        one_case = _dp_one_process(case)
        row = {"launches_per_rank": r0["launches"], "kernel_errs": [r0["kernel_errs"],
                                                                     r1["kernel_errs"]]}
        if one_case is not None:
            one = _dp_epoch(dev, one_case)
            rel = {k: abs(r0["metrics"][k] - one["metrics"][k]) / max(abs(one["metrics"][k]),
                                                                      1e-30)
                   for k in DP_ROLLOUT_KEYS[case["kind"]]}
            bad = {k: v for k, v in rel.items() if not v <= 1e-5}
            if bad:
                fail(f"dp_parity {name}: rollout differs from one process {bad}")
            row["rollout_rel_err"] = max(rel.values())
            ref, tol = one["params"], DP_PARAM_TOL[case["kind"]]
        else:
            ref, tol = host[0][name]["params"], DP_PARAM_TOL["im"]
            row["reference"] = "two gloo ranks on the CPU"
        # imitation: 2·steps·lr elementwise (lr the config's 2e-5)
        steps = cfg["mini_epochs"] * r0["steps"]
        atol = tol[0] * steps * 2e-5 if case["kind"] == "im" else tol[0]
        _, init = _dp_build(torch.device("cpu"), case)
        row["update_rel_err"] = _close(f"dp_parity {name}", r0["params"], ref, atol, tol[1],
                                       {k: v.detach() for k, v in init.params.items()})
        rows[name] = row
    say("dp_parity", card=card, nvidia_smi=nvidia_smi(), ranks=DP_RANKS,
        backend="gloo, one card shared", overlapped_wall_s=time.perf_counter() - t0,
        overlapped_with="dp_cli's two command-line processes", cases=rows)
    return {name: row["launches_per_rank"] for name, row in rows.items()}


# the kernels each dp case's path runs, held on its inputs
DP_CHECKED = {"im_per_minibatch": ("k1_scalar_rel", "k1_update"), "im_local_sgd": (),
              "tennis_stage1": ("k2", "k3"), "dual_rally": ("k2", "k3")}
DP_MAIN_CHECKED = {"amass_im_per_minibatch": DP_CHECKED["im_per_minibatch"],
                   "amass_im_local_sgd": (), "federer_train_stage_1": ("k2", "k3"),
                   "nadal_federer": ("k2", "k3")}
# each kernel against its plain version on a rank's inputs: K1's norm sums in
# f64 against the plain f32 tree (relative 1e-6), its update bit for bit
# under the same scalars; K2 to 1e-4 of its output's scale (3xTF32); K3 bit
# for bit
DP_HELD = {"k1_scalar_rel": 1e-6, "k1_update": 0.0, "k2": 1e-4, "k3": 0.0}
# rollout metrics a dp case holds to the one-process run
DP_ROLLOUT_KEYS = {
    "im": ("reward_mean", "alive_ratio", "episode_return", "success_rate"),
    "tennis": ("reward_mean", "done_rate", "episode_return", "racket_ball_dist"),
    "dual": ("reward_mean", "done_rate", "episode_return", "racket_ball_dist")}
# parameter tolerances: imitation 2·steps·lr elementwise and 1% of the
# update's norm (tests/test_torch_dp_imitation.py's one-process bound), tennis
# 2e-6 and 1e-3 (tests/test_torch_dp_tennis.py)
DP_PARAM_TOL = {"im": (2.0, 0.01), "tennis": (2e-6, 1e-3), "dual": (2e-6, 1e-3)}


class _DPTimers:
    """Host-clock times of the learners' flat all-reduces in this process
    (synchronized before and after): the per-step gradient bucket and the
    local-SGD average (`mean=True`)."""

    def __init__(self):
        import torch

        import vid2player3d_torch.parallel.mesh as PM

        self.grad, self.sync = [], []
        orig = PM.flat_all_reduce

        def timed(tensors, mesh, mean=False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(tensors, mesh, mean)
            torch.cuda.synchronize()
            (self.sync if mean else self.grad).append(time.perf_counter() - t)
            return out

        PM.flat_all_reduce = timed

    def reset(self):
        self.grad.clear()
        self.sync.clear()


def _dp_main_builds(dev, mesh, pool):
    """dp_main's four paths as (name, kind, build function) at full widths."""
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv, TennisConfig
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig, V2PConfig, V2PPPO
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    def imitation(**kw):
        def build():
            lib = make_synthetic_motion_lib(num_motions=8, T=300, fps=30.0, seed=0, device=dev)
            env = HumanoidImEnv(HumanoidImConfig(num_envs=DP_IM_ENVS, substeps=SUBSTEPS), lib,
                                rng=0, device=dev).shard(mesh)
            return ImitationPPO(env, PPOConfig(horizon=DP_IM_HORIZON, **kw), seed=7, mesh=mesh)
        return build

    def stage1():
        env_cfg = TennisConfig(num_envs=DP_TENNIS_ENVS, substeps=2, max_episode_length=600,
                               reward_type="reach", use_random_ball_target="discrete",
                               reset_reaction_nframes=70, reset_candidates=256)
        env = _tennis_env(dev, env_cfg, hidden=256, experts=6,
                          gen=TennisBallGenerator.from_arrays(*pool, device=dev)).shard(mesh)
        return V2PPPO(env, V2PConfig(horizon=DP_TENNIS_HORIZON, minibatch_size=TENNIS_MINIBATCH,
                                     mini_epochs=TENNIS_MINI_EPOCHS, learning_rate=1e-4,
                                     sigma_init=-0.69, bounds_loss_coef=10.0), seed=7, mesh=mesh)

    def dual():
        env_cfg = TennisConfig(num_envs=DP_DUAL_ENVS, substeps=6, max_episode_length=300,
                               reward_type="return_w_estimate",
                               use_random_ball_target="continuous", reset_reaction_nframes=70,
                               reset_candidates=0, ball_reaction_force=True,
                               ball_body_contact=True)
        env = _dual_env(dev, env_cfg, hidden=256, experts=6,
                        gen=TennisBallGenerator.from_arrays(*pool, device=dev)).shard(mesh)
        return V2PPPO(env, V2PConfig(horizon=DP_DUAL_HORIZON, minibatch_size=DP_DUAL_MINIBATCH,
                                     minibatch_per_chip=True, mini_epochs=DUAL_MINI_EPOCHS,
                                     learning_rate=1e-5, sigma_init=-2.9, bounds_loss_coef=10.0,
                                     num_policies=2), seed=7, mesh=mesh)

    return (("amass_im_per_minibatch", "im",
             imitation(minibatch_size=MINIBATCH, mini_epochs=DP_PER_MINIBATCH_MINI_EPOCHS,
                       fused_optimizer="on")),
            ("amass_im_local_sgd", "im",
             imitation(minibatch_size=MINIBATCH, mini_epochs=DP_LOCAL_SGD_MINI_EPOCHS,
                       minibatch_per_chip=True, dp_sync="per_mini_epoch")),
            ("federer_train_stage_1", "tennis", stage1),
            ("nadal_federer", "dual", dual))


def _dp_main_rank(mesh, pool):
    """One rank of dp_main: each path's epoch at full width on this rank's
    shard, timed; the kernels' launches in the epoch, and each kernel held
    against its plain version on the inputs this epoch gave it, at each of
    its shapes."""
    import math

    import torch

    timers = _DPTimers()
    rec = _KernelRecorder()
    out = {}
    for name, kind, build in _dp_main_builds(mesh.device, mesh, pool):
        t0 = time.perf_counter()
        agent = build()
        ts = agent.init_state()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rollout_s, unwrap = _timed_rollouts(agent)
        rec.watch(agent.env)
        timers.reset()
        _zero_kernel_counts()
        t0 = time.perf_counter()
        ts, m = agent.train_epoch(ts)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = _kernel_counts()
        kernel_errs, kernel_shapes = rec.check(), rec.shapes()
        rec.last.clear()
        unwrap()
        metrics = {k: float(v) for k, v in m.items()}
        update_s = epoch_s - rollout_s[-1]
        n = agent.env.cfg.num_envs
        out[name] = dict(
            kind=kind, envs_per_rank=n, envs=agent.num_envs_global, horizon=agent.cfg.horizon,
            setup_s=setup_s, epoch_s=epoch_s, rollout_s=rollout_s[-1], update_s=update_s,
            rollout_env_steps_per_s=agent.num_envs_global * agent.cfg.horizon / rollout_s[-1],
            optimizer_steps=agent.cfg.mini_epochs * agent.num_minibatches,
            grad_all_reduces=len(timers.grad),
            all_reduce_ms_per_step=1e3 * sum(timers.grad) / max(len(timers.grad), 1),
            all_reduce_share_of_update=sum(timers.grad) / update_s,
            local_sgd_syncs=len(timers.sync),
            sync_ms_per_mini_epoch=1e3 * sum(timers.sync) / max(len(timers.sync), 1),
            launches=launches, kernel_errs=kernel_errs, kernel_shapes=kernel_shapes,
            lanes=len(getattr(agent.env, "_lane_specs", ())),
            reset_candidates=getattr(agent.env.cfg, "reset_candidates", 0),
            count=int(ts.opt_state.count),
            fused=getattr(agent, "use_fused", False) and not getattr(agent, "local_sgd", False),
            finite=all(math.isfinite(v) for v in metrics.values()),
            metrics={k: metrics[k] for k in ("reward_mean", "kl", "c_loss") if k in metrics},
            grad_skip=metrics.get("grad_skip", 0.0),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del agent, ts
        torch.cuda.empty_cache()
    return out


def dp_main_phase(dev, card: str):
    """dp_main: the DP paths at full widths, two gloo ranks sharing the card."""
    from vid2player3d_torch import parallel
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    t0 = time.perf_counter()
    pool = TennisBallGenerator(num_candidates=4096, seed=0, device="cpu")
    arrays = [a.numpy() for a in (pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                  pool.launch_vspin)]
    ranks = parallel.spawn(_dp_main_rank, DP_RANKS, args=(arrays,), backend="gloo", device=dev,
                           timeout_s=DP_TIMEOUT_S)
    launches = {}
    for name in ranks[0]:
        rows = [r[name] for r in ranks]
        kind = rows[0]["kind"]
        want = _expected_launches(kind, rows[0]["optimizer_steps"], rows[0]["horizon"],
                                  rows[0]["fused"])
        for r, row in enumerate(rows):
            if row["launches"] != want:
                fail(f"dp_main {name} rank {r}: launches {row['launches']}, expected {want}")
            errs = row["kernel_errs"]
            if set(errs) != set(DP_MAIN_CHECKED[name]) \
                    or any(not errs[k] <= DP_HELD[k] for k in errs):
                fail(f"dp_main {name} rank {r}: kernels against their plain versions {errs}")
            # every shape the epoch gave a kernel is checked; among them the
            # path's own: K2 at the rank's envs per lane, K3 at the rank's
            # envs and at the global candidate resets
            n, K = row["envs_per_rank"], row["reset_candidates"]
            need = {"k2": {n // row["lanes"]} if "k2" in errs else set(),
                    "k3": ({n} | ({K} if 0 < K < row["envs"] else set()))
                    if "k3" in errs else set()}
            if any(not need[k] <= set(row["kernel_shapes"][k]) for k in need):
                fail(f"dp_main {name} rank {r}: kernels checked at {row['kernel_shapes']}, the "
                     f"path's shapes are {need}")
            if not row["finite"] or row["grad_skip"] != 0.0:
                fail(f"dp_main {name} rank {r}: metrics {row['metrics']}, grad_skip "
                     f"{row['grad_skip']}")
            if row["count"] != row["optimizer_steps"]:
                fail(f"dp_main {name} rank {r}: optimizer count {row['count']}")
            syncs = DP_LOCAL_SGD_MINI_EPOCHS if name.endswith("local_sgd") else 0
            if row["local_sgd_syncs"] != syncs or \
                    row["grad_all_reduces"] != (0 if syncs else row["optimizer_steps"]):
                fail(f"dp_main {name} rank {r}: {row['grad_all_reduces']} gradient all-reduces "
                     f"and {row['local_sgd_syncs']} local-SGD syncs")
        launches[name] = want
        say("dp_main", path=name, card=card, nvidia_smi=nvidia_smi(), ranks=DP_RANKS,
            backend="gloo, one card shared", per_rank=rows)
    say("dp_main_total", card=card, nvidia_smi=nvidia_smi(), seconds=time.perf_counter() - t0)
    return launches


def dp_cli_start():
    """dp_cli's two processes, started: `--n_devices 1` (NCCL at world size
    1) and `--n_devices 2` on this one-card machine. They run beside
    dp_parity: neither phase's wall time is a measurement."""
    import shutil

    out = os.path.join(REPO, "build", f"dp_cli_{os.getpid()}")
    shutil.rmtree(out, ignore_errors=True)
    return out, time.perf_counter(), (
        _cli_subprocess(["--cfg", "amass_im", "--n_devices", "1", "--num_envs", "4096",
                         "--epochs", "1", "--out", out]),
        _cli_subprocess(["--cfg", "amass_im", "--n_devices", "2", "--num_envs", "4096",
                         "--epochs", "1", "--out", out + "_two"]))


def _beside(started, phase, *args):
    """Run `phase(*args)` while dp_cli's processes run; if it fails, stop
    them before the script exits."""
    try:
        return phase(*args)
    except BaseException:
        for proc, _ in started[2]:
            proc.kill()
            proc.communicate()
        raise


def dp_cli_phase(dev, card: str, started):
    """dp_cli: `--n_devices 1` ran over NCCL at world size 1 and its
    checkpoint reads back; `--n_devices 2` on this one-card machine failed
    with both counts."""
    import math
    import shutil

    import numpy as np

    from vid2player3d_torch.learn import FrozenImitator
    from vid2player3d_torch.utils import checkpoint as CK

    out, t0, (one, two) = started
    try:
        proc, _ = two
        two_out, two_err = proc.communicate(timeout=300)
        if proc.returncode == 0 or "--n_devices 2 needs 2 cards" not in two_err \
                or "1 visible" not in two_err:
            fail(f"--n_devices 2 on one card: exit {proc.returncode}\n{two_err[-2000:]}")
        text, _ = _cli_wait("amass_im --n_devices 1", one)
        if "1 rank(s) over nccl" not in text:
            fail(f"--n_devices 1 did not run NCCL: {text[-1000:]}")
        path = os.path.join(out, "latest.npz")
        flat = CK.load_npz(path)
        frozen = FrozenImitator.from_checkpoint(path, device=dev)
        if int(flat["epoch"]) != 1 or not all(np.isfinite(v).all() for v in flat.values()) \
                or not all(math.isfinite(float(p.abs().sum()))
                           for p in frozen.net.parameters()):
            fail("--n_devices 1 checkpoint does not read back")
        say("dp_cli", card=card, nvidia_smi=nvidia_smi(),
            overlapped_wall_s=time.perf_counter() - t0, overlapped_with="dp_parity",
            files=sorted(os.listdir(out)), epoch=int(flat["epoch"]),
            refusal=two_err.strip().splitlines()[-1])
    finally:
        for proc, _ in (one, two):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out + "_two", ignore_errors=True)


# ---------------------------------------------------------------------------
# slice 8: the host-side data tools, their outputs driven into the card paths
# ---------------------------------------------------------------------------

AMASS_CLIPS, AMASS_FRAMES, AMASS_FPS = 32, 1200, 120.0   # 10 s at 120 Hz -> 300 frames at 30
FBX_SECONDS, FBX_KEYS_PER_S = 4.0, 30
DATA_STATE_SAMPLES = 4096
DATA_MVAE_BATCHES = 50


def _mvae_steps_per_window() -> int:
    from vid2player3d_torch.mvae import MVAEOption

    opt = MVAEOption.load("federer")
    return opt.nframes_seq - opt.num_future_predictions - opt.num_condition_frames + 1


def write_amass_fixture(d: str, n: int = AMASS_CLIPS, T: int = AMASS_FRAMES,
                        fps: float = AMASS_FPS, seed: int = 0) -> None:
    """An AMASS-layout directory: `n` SMPLH clips (poses (T, 156) with hand
    dims, trans (T, 3), 16 betas, genders neutral/male/female in turn,
    `mocap_framerate`) in four subject folders, upright (the SMPL body's y
    axis to the world's z), walking with joint swings; plus one clip too
    short to keep after downsampling and one file that is no npz."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(T) / fps
    for i in range(n):
        sub = os.path.join(d, f"subject_{i % 4}")
        os.makedirs(sub, exist_ok=True)
        poses = np.zeros((T, 156), np.float32)
        poses[:, 3:66] = 0.25 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0, 63) * t[:, None]
                                       + rng.uniform(0, 2 * np.pi, 63))
        poses[:, 66:] = 0.1 * rng.standard_normal(90)          # hands: dropped
        # root: yaw(t) after the base rotation (120 deg about (1, 1, 1))
        yaw = 0.3 * np.sin(2 * np.pi * 0.2 * t)
        qb = np.array([0.5, 0.5, 0.5, 0.5])
        qz = np.stack([np.zeros(T), np.zeros(T), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
        w = qz[:, 3] * qb[3] - qz[:, 2] * qb[2]
        v = qz[:, 3:4] * qb[:3] + qb[3] * qz[:, :3] + np.cross(qz[:, :3], qb[:3])
        s = np.linalg.norm(v, axis=-1, keepdims=True)
        poses[:, :3] = 2.0 * np.arctan2(s, w[:, None]) * v / s
        trans = np.stack([0.5 * t, 0.1 * np.sin(t), np.full(T, 0.95)], 1).astype(np.float32)
        np.savez(os.path.join(sub, f"clip_{i:03d}.npz"), poses=poses, trans=trans,
                 betas=rng.uniform(-1, 1, 16).astype(np.float32),
                 gender=("neutral", "male", "female")[i % 3], mocap_framerate=np.float64(fps))
    # 36 frames at 120 Hz: 9 after downsampling, fewer than the 10 kept
    np.savez(os.path.join(d, "short.npz"), poses=np.zeros((36, 156), np.float32),
             trans=np.zeros((36, 3), np.float32), betas=np.zeros(16, np.float32),
             gender="male", mocap_framerate=np.float64(fps))
    with open(os.path.join(d, "broken.npz"), "wb") as f:
        f.write(b"not an npz archive")


def _fbx_scene(seconds: float = FBX_SECONDS, keys_per_s: int = FBX_KEYS_PER_S, seed: int = 0):
    """A 24-joint SMPL-named chain as FBX records (name, props, children):
    each joint a LimbNode Model with `Lcl Translation` (the synthetic SMPL
    rest offsets, y up), the shoulders a `PreRotation`; every joint a
    rotation curve node with X/Y/Z curves (degrees) and the pelvis a
    translation one, keyed `keys_per_s` times a second. Arrays are numpy:
    int64 key times, float32 values."""
    import numpy as np
    import torch

    from vid2player3d_torch.core import smpl as S

    rest = S.rest_joints(S.make_synthetic_smpl(), torch.zeros(1, 10))[0].numpy()
    rng = np.random.default_rng(seed)
    kt = (np.arange(int(seconds * keys_per_s) + 1, dtype=np.int64)
          * (46186158000 // keys_per_s))
    tk = np.arange(len(kt)) / keys_per_s
    P = lambda *v: ("P", v, [])                                    # noqa: E731
    models, anim, conns = [], [], []
    for j, name in enumerate(S.SMPL_BONE_ORDER_NAMES):
        p = int(S.SMPL_PARENTS[j])
        off = rest[j] - (rest[p] if p >= 0 else 0.0)
        props = [P("Lcl Translation", "Lcl Translation", "", "A", *map(float, off))]
        if name.endswith("Shoulder"):
            props.append(P("PreRotation", "Vector3D", "", "", 0.0, 0.0,
                           -20.0 if name[0] == "L" else 20.0))
        models.append(("Model", (1000 + j, f"Model::{name}", "LimbNode"),
                       [("Properties70", (), props)]))
        conns.append(("C", ("OO", 1000 + j, 1000 + p if p >= 0 else 0), []))
        channels = [("Lcl Rotation", 2000 + j, 20.0)]
        if j == 0:
            channels.append(("Lcl Translation", 2100, None))
        for channel, cn, amp in channels:
            anim.append(("AnimationCurveNode", (cn, f"AnimCurveNode::{channel[4]}", ""), []))
            conns.append(("C", ("OP", cn, 1000 + j, channel), []))
            for k, axis in enumerate("XYZ"):
                cid = 10 * cn + k
                if amp is None:
                    vals = off[k] + (0.6 * tk if axis == "X" else 0.0 * tk)
                else:
                    vals = amp * rng.uniform(0.3, 1.0) * np.sin(
                        2 * np.pi * rng.uniform(0.3, 1.2) * tk + rng.uniform(0, 2 * np.pi))
                anim.append(("AnimationCurve", (cid, "AnimCurve::", ""),
                             [("KeyTime", (kt,), []),
                              ("KeyValueFloat", (vals.astype(np.float32),), [])]))
                conns.append(("C", ("OP", cid, cn, f"d|{axis}"), []))
    return [("Objects", (), models + anim), ("Connections", (), conns)]


def fbx_ascii(records) -> str:
    """FBX 7.4 ASCII text of `_fbx_scene`'s records (arrays as `*N {a: ...}`;
    floats written with repr, float32 arrays at their exact values)."""
    import numpy as np

    def value(v):
        if isinstance(v, str):
            return f'"{v}"'
        return repr(float(v)) if isinstance(v, float) else str(int(v))

    def rec(node, indent):
        name, props, children = node
        pad = "    " * indent
        if len(props) == 1 and isinstance(props[0], np.ndarray):
            arr = props[0]
            vals = ",".join(value(float(x) if arr.dtype.kind == "f" else int(x)) for x in arr)
            return f"{pad}{name}: *{len(arr)} {{\n{pad}    a: {vals}\n{pad}}}\n"
        head = f"{pad}{name}: " + ", ".join(value(v) for v in props)
        if not children:
            return head + "\n"
        return head + " {\n" + "".join(rec(c, indent + 1) for c in children) + pad + "}\n"

    return "; FBX 7.4 project file\n" + "".join(rec(r, 0) for r in records)


def fbx_binary(records, compress: bool = True) -> bytes:
    """The Kaydara binary container (version 7400, 32-bit offsets) of the
    same records; arrays zlib-compressed when `compress`."""
    import struct
    import zlib

    import numpy as np

    def prop(v):
        if isinstance(v, np.ndarray):
            code = {"f": b"f", "i": b"l"}[v.dtype.kind]
            raw = v.astype("<f4" if code == b"f" else "<i8").tobytes()
            payload = zlib.compress(raw) if compress else raw
            return code + struct.pack("<III", len(v), int(compress), len(payload)) + payload
        if isinstance(v, str):
            raw = b"\x00\x01".join(s.encode() for s in reversed(v.split("::")))
            return b"S" + struct.pack("<I", len(raw)) + raw
        if isinstance(v, float):
            return b"D" + struct.pack("<d", v)
        return b"L" + struct.pack("<q", int(v))

    def node(rec, start):
        name, props, children = rec
        nb, plist = name.encode(), b"".join(prop(p) for p in props)
        sub = b""
        for c in children:
            sub += node(c, start + 13 + len(nb) + len(plist) + len(sub))
        if children:
            sub += b"\x00" * 13
        end = start + 13 + len(nb) + len(plist) + len(sub)
        return struct.pack("<IIIB", end, len(props), len(plist), len(nb)) + nb + plist + sub

    doc = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for r in records:
        doc += node(r, len(doc))
    return doc + b"\x00" * 13


def _libs_close(what, a, b, atol=1e-5):
    """Every field of two MotionLibs (on any devices) within `atol`."""
    import dataclasses

    worst = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{what}: {f.name} {tuple(x.shape)} {x.dtype} against {tuple(y.shape)} {y.dtype}")
        if x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    if worst > atol:
        fail(f"{what}: the card's library differs from the CPU's by {worst} (> {atol})")
    return worst


def _states_close(what, lib, ref, seed=0, atol=1e-5):
    """`get_motion_state` of `lib` (on the card) and `ref` (on the CPU) at
    the same random motions and times, every output finite; each output
    within `atol` plus twice how far the CPU's float32 result lies from the
    same call in float64. The positions and velocities are well conditioned
    (their float64 gap is below 1e-5); the rotations are not: the slerp's
    arccos near cos = 1, and its switch to the midpoint below sin = 0.001,
    turn an ulp of the dot product into up to ~1e-3. Returns {key: (card -
    CPU, bound)}."""
    import dataclasses

    import torch

    from vid2player3d_torch.data.motion_lib import MotionLib, get_motion_state

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, ref.num_motions, (DATA_STATE_SAMPLES,), generator=g)
    times = torch.rand(DATA_STATE_SAMPLES, generator=g) * ref.motion_lengths[ids]
    want = get_motion_state(ref, ids, times)
    ref64 = MotionLib(**{f.name: (v.double() if v.is_floating_point() else v) for f in
                         dataclasses.fields(ref) for v in (getattr(ref, f.name),)})
    exact = get_motion_state(ref64, ids, times.double())
    got = get_motion_state(lib, ids.to(lib.device), times.to(lib.device))
    errs = {}
    for k, v in want.items():
        g_k = got[k].cpu()
        if not bool(torch.isfinite(g_k).all()):
            fail(f"{what}: {k} not finite")
        bound = atol + 2.0 * float((v.double() - exact[k]).abs().max())
        errs[k] = (float((g_k - v).abs().max()), bound)
        if errs[k][0] > bound:
            fail(f"{what}: get_motion_state's {k} on the card differs from the CPU's by "
                 f"{errs[k][0]} (> {bound})")
    return errs


def data_phase(dev, card: str, keep_dataset=None):
    """The host-side data tools at the sizes users run them, and their
    outputs through the card paths, in a directory under build/:
    1. an AMASS-layout directory (32 SMPLH clips of 1200 frames at 120 Hz,
       one too short, one broken) through `convert_amass_dir` on the card
       and on the CPU (32 motions at 30 fps; every field within 1e-5;
       `get_motion_state` at 4096 random times within 1e-5 plus twice the
       CPU's float32 gap to float64), the saved file read back on the card
       into one amass_im epoch at the main path's sizes with K1 counted
       (1,536 + 1,536);
    2. `python -m vid2player3d_torch.data.tennis_motion` at its defaults (96
       sequences x 6 cycles) as a process of its own, then `--cfg
       mvae_federer --dataset_dir` on it in this process (1 epoch of 50
       windows at full width) with K2 counted inside the epoch (3 prep + 3
       GEMM per optimizer step) and in the rest of the call (the 120-step
       random-walk report);
    3. `tennis_motion_lib()` at its defaults on the card and on the CPU
       (every field within 1e-5), saved, and `--cfg federer_im
       --motion_file` on it at 4096 envs for one epoch;
    4. a 24-joint FBX chain written as ASCII and as binary (zlib arrays),
       both imported and equal, retargeted onto the humanoid tree and built
       into a library on the card whose states are finite.
    With `keep_dataset` the generated tennis dataset is moved there (for
    the `learn` phase's MotionVAE), the rest removed."""
    import json
    import math
    import shutil

    import numpy as np
    import torch

    from vid2player3d_torch.core import fbx as FBX
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.core.skeleton import retarget_motion_by_tpose
    from vid2player3d_torch.data import amass as AM
    from vid2player3d_torch.data import tennis_motion as TM
    from vid2player3d_torch.data.motion_lib import MotionLib, get_motion_state
    from vid2player3d_torch.mvae.train import MVAETrainer
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    D = os.path.join(REPO, "build", f"data_smoke_{os.getpid()}")
    shutil.rmtree(D, ignore_errors=True)
    os.makedirs(D)
    out, steps_s = {}, {}
    t_phase = time.perf_counter()
    try:
        # 1. AMASS -> MotionLib -> one amass_im epoch with K1
        amass = os.path.join(D, "amass")
        t0 = time.perf_counter()
        write_amass_fixture(amass)
        steps_s["amass_fixture"] = time.perf_counter() - t0
        smpl = S.make_synthetic_smpl()
        lib_path = os.path.join(D, "amass_lib.npz")
        t0 = time.perf_counter()
        lib = AM.convert_amass_dir(amass, smpl_model=smpl, out_path=lib_path, device=dev)
        torch.cuda.synchronize()
        steps_s["amass_convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = AM.convert_amass_dir(amass, smpl_model=smpl, device="cpu")
        steps_s["amass_convert_cpu"] = time.perf_counter() - t0
        dts = lib.motion_dt.cpu().numpy()
        if lib.num_motions != AMASS_CLIPS or not lib.gts.is_cuda \
                or not np.all(dts == np.float32(1.0 / 30.0)) \
                or not np.all(lib.motion_num_frames.cpu().numpy() == AMASS_FRAMES // 4):
            fail(f"amass: {lib.num_motions} motions on {lib.device}, dt {sorted(set(dts))}")
        out["amass_lib_max_abs_err"] = _libs_close("amass", lib, ref)
        out["amass_state_err_bound"] = _states_close("amass", lib, ref)
        lib = MotionLib.load(lib_path, device=dev)
        _, _, rows, k1_launches, _, timing = _imitation_main(dev, "amass_im", 1, lib=lib)
        steps_s["amass_im_epoch"] = timing["epoch_s"][0]
        out.update(amass_im_k1_launches=k1_launches, amass_im_timing=timing,
                   amass_im_metrics=rows[0], amass_frames=int(lib.gts.shape[0]))
        del lib, ref

        # 2. the generator's command line, then mvae_federer on its dataset
        ds_dir = os.path.join(D, "tennis_ds")
        env = dict(os.environ, PYTHONPATH=REPO)
        t0 = time.perf_counter()
        gen = subprocess.run([sys.executable, "-m", "vid2player3d_torch.data.tennis_motion",
                              ds_dir], cwd=REPO, env=env, capture_output=True, text=True,
                             timeout=600)
        steps_s["tennis_dataset_cli"] = time.perf_counter() - t0
        if gen.returncode != 0 or "head_speed@contact" not in gen.stdout:
            fail(f"tennis_motion: exit {gen.returncode}\n{gen.stdout[-2000:]}{gen.stderr[-2000:]}")
        manifest = json.load(open(os.path.join(ds_dir, "manifest.json")))
        out.update(tennis_dataset_videos=len(manifest),
                   tennis_dataset_frames=int(np.load(os.path.join(ds_dir, "valid.npy")).shape[0]),
                   tennis_dataset_report=gen.stdout.strip().splitlines()[-1].split("  ")[-1])
        if len(manifest) != 96:
            fail(f"tennis_motion: {len(manifest)} videos, expected 96")

        epoch_k2, epoch_steps, epoch_s = [], [], []
        orig = MVAETrainer.train_epoch

        def counted(self, *a, **kw):
            torch.cuda.synchronize()
            c0 = (MOE.split_weights.launches, MOE.moe_linear.launches)
            n0, t0 = int(self.opt_state.count), time.perf_counter()
            res = orig(self, *a, **kw)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            epoch_steps.append(int(self.opt_state.count) - n0)
            epoch_k2.append((MOE.split_weights.launches - c0[0], MOE.moe_linear.launches - c0[1]))
            return res

        MVAETrainer.train_epoch = counted
        try:
            MOE.moe_linear.launches = MOE.split_weights.launches = 0
            text, steps_s["mvae_cli"] = _cli_call(["--cfg", "mvae_federer", "--dataset_dir",
                                                   ds_dir, "--epochs", "1", "--mvae_batches",
                                                   str(DATA_MVAE_BATCHES), "--out", D])
            total = (MOE.split_weights.launches, MOE.moe_linear.launches)
        finally:
            MVAETrainer.train_epoch = orig
        n = epoch_steps[0] if epoch_steps else 0
        if epoch_k2 != [(3 * n, 3 * n)] or n != DATA_MVAE_BATCHES * _mvae_steps_per_window():
            fail(f"data mvae: the epoch's {n} optimizer steps launched K2 {epoch_k2}")
        rest = (total[0] - 3 * n, total[1] - 3 * n)
        if rest != (3 * MVAE_REPORT_STEPS, 3 * MVAE_REPORT_STEPS):
            fail(f"data mvae: {rest} launches outside the epoch (the random walk's "
                 f"{MVAE_REPORT_STEPS} steps)")
        row = json.loads(open(os.path.join(D, "metrics.jsonl")).readlines()[-1])
        losses = {k: v for k, v in row.items() if k not in ("epoch", "wall_s")}
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"data mvae: non-finite losses {losses}")
        if not os.path.exists(os.path.join(D, "mvae_federer", "latest.npz")):
            fail("data mvae: no latest.npz")
        if "dataset: " + ds_dir not in text or _json_block(text).get("finite") is not True:
            fail("data mvae: not trained on the generated dataset, or a non-finite report")
        if keep_dataset is not None:
            shutil.move(ds_dir, keep_dataset)
        out.update(mvae_optimizer_steps=n, mvae_epoch_k2=dict(prep=3 * n, gemm=3 * n),
                   mvae_rest_k2=dict(prep=rest[0], gemm=rest[1]), mvae_epoch_s=epoch_s[0],
                   mvae_ms_per_optimizer_step=epoch_s[0] / n * 1e3, mvae_losses=losses,
                   mvae_report=_json_block(text))

        # 3. the tennis motion library -> federer_im fine-tune
        t0 = time.perf_counter()
        tlib = TM.tennis_motion_lib(device=dev, out_path=os.path.join(D, "tennis_lib.npz"))
        torch.cuda.synchronize()
        steps_s["tennis_motion_lib"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tref = TM.tennis_motion_lib(device="cpu")
        steps_s["tennis_motion_lib_cpu"] = time.perf_counter() - t0
        nf = tlib.motion_num_frames.cpu().numpy()
        if tlib.num_motions != 32 or not tlib.gts.is_cuda or np.any(nf % 128):
            fail(f"tennis_motion_lib: {tlib.num_motions} motions, frames {nf}")
        out["tennis_lib_max_abs_err"] = _libs_close("tennis_motion_lib", tlib, tref)
        out["tennis_state_err_bound"] = _states_close("tennis_motion_lib", tlib, tref, seed=1)
        out["tennis_lib_frames"] = int(nf.sum())
        del tlib, tref
        im_dir = os.path.join(D, "federer_im")
        _, steps_s["federer_im_cli"] = _cli_call(
            ["--cfg", "federer_im", "--motion_file", os.path.join(D, "tennis_lib.npz"),
             "--num_envs", str(NUM_ENVS), "--epochs", "1", "--out", im_dir])
        row = json.loads(open(os.path.join(im_dir, "metrics.jsonl")).readlines()[-1])
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        if bad or not os.path.exists(os.path.join(im_dir, "best.npz")):
            fail(f"data federer_im: non-finite {bad} or no best.npz")
        out["federer_im_metrics"] = {k: row[k] for k in ("reward_mean", "alive_ratio", "kl")}

        # 4. FBX: ASCII and binary, retargeted onto the humanoid tree
        scene = _fbx_scene()
        files = {"ascii": os.path.join(D, "chain.fbx"), "binary": os.path.join(D, "chain_bin.fbx")}
        with open(files["ascii"], "w") as f:
            f.write(fbx_ascii(scene))
        with open(files["binary"], "wb") as f:
            f.write(fbx_binary(scene))
        t0 = time.perf_counter()
        motions = {k: FBX.import_fbx_motion(p, fps=30.0) for k, p in files.items()}
        steps_s["fbx_import_both"] = time.perf_counter() - t0
        a, b = motions["ascii"], motions["binary"]
        if a.tree.node_names != b.tree.node_names or len(a.tree.node_names) != 24 \
                or not np.array_equal(a.local_rotation, b.local_rotation) \
                or not np.array_equal(a.root_translation, b.root_translation) \
                or a.num_frames != int(FBX_SECONDS * 30) + 1:
            fail("fbx: the ASCII and binary imports differ")
        target = AM.humanoid_skeleton_tree(smpl, np.zeros(10, np.float32))
        t0 = time.perf_counter()
        moved = retarget_motion_by_tpose(
            a, np.tile([0.0, 0.0, 0.0, 1.0], (24, 1)), target, np.tile([0.0, 0.0, 0.0, 1.0], (24, 1)),
            {n: n for n in a.tree.node_names}, np.array([np.sqrt(0.5), 0.0, 0.0, np.sqrt(0.5)]), 1.0)
        steps_s["fbx_retarget"] = time.perf_counter() - t0
        flib = AM.build_motion_lib([dict(
            motion=moved, motion_body=np.zeros(11, np.float32), body_scale=1.0,
            min_verts_h=float(moved.global_translation[..., 2].min()) - 0.05)], device=dev)
        st = get_motion_state(flib, torch.zeros(64, dtype=torch.long, device=dev),
                              torch.linspace(0, float(flib.motion_lengths[0]), 64, device=dev))
        if not flib.gts.is_cuda or not all(bool(torch.isfinite(v).all()) for v in st.values()):
            fail("fbx: the retargeted library's states are not finite on the card")
        out.update(fbx_frames=a.num_frames, fbx_bytes={k: os.path.getsize(p)
                                                       for k, p in files.items()})
    finally:
        shutil.rmtree(D, ignore_errors=True)
    say("data", card=card, nvidia_smi=nvidia_smi(), amass_clips=AMASS_CLIPS,
        amass_frames_per_clip=AMASS_FRAMES, amass_fps=AMASS_FPS, im_envs=NUM_ENVS,
        steps_s=steps_s, phase_s=time.perf_counter() - t_phase, **out)
    return {"k1": out["amass_im_k1_launches"],
            "k2": {"moe_split_w": out["mvae_epoch_k2"]["prep"] + out["mvae_rest_k2"]["prep"],
                   "moe_linear": out["mvae_epoch_k2"]["gemm"] + out["mvae_rest_k2"]["gemm"]}}


# ---------------------------------------------------------------------------
# slice 15: the port learns on the card (the JAX package's learning checks)
# ---------------------------------------------------------------------------

# L1: the amass_im artifact's command (artifacts/amass_im_500ep) cut from 500
# epochs to 100, then to 80 and to 60 to keep the script inside its time
# limit, fused K1; its checks: alive_ratio over the last 10 epochs at least
# LEARN_ALIVE_GAIN above epochs 1-10's (the JAX v5e run: +0.142 at 100
# epochs; the port +0.115 at 80, +0.098-0.101 at 60 in three 500-epoch runs
# of the command line), c_loss over epochs 6-10 at most
# LEARN_CLOSS_FRAC of epoch 1's (JAX: 0.150)
LEARN_ENVS, LEARN_EPOCHS = 2048, 60
LEARN_ALIVE_GAIN, LEARN_CLOSS_FRAC = 0.08, 0.5
LEARN_JAX_EPOCHS = (1, 10, 50, 60)
LEARN_ROW_KEYS = ("reward_mean", "alive_ratio", "body_pos_reward", "c_loss", "kl",
                  "success_rate")
# L2: eval_imitation's full episodes, 2 resets of every env (cut from its
# default 5 to keep the script inside its time limit)
LEARN_EVAL_ROLLOUTS = 2
# L3: tests/test_pi_low.py's tracking curve at its own size
TRACK_ENVS, TRACK_BLOCKS, TRACK_EPOCHS_PER_BLOCK, TRACK_STEPS = 64, 5, 5, 16
# L4: mvae_federer, 4 epochs of the config's 500 windows (cut from 6 to keep
# the script inside its time limit); recon at epoch 4 at most
# LEARN_MVAE_FRAC of epoch 1's (the JAX v5e run: 0.119; the port 0.121)
LEARN_MVAE_EPOCHS, LEARN_MVAE_FRAC = 4, 0.25
# L5: the trained pi_low in federer_train_stage_1 at its 10,240 envs
LEARN_STAGE1_EPOCHS = 2
JAX_AMASS_METRICS = os.path.join(REPO, "artifacts", "amass_im_500ep", "metrics.jsonl")
JAX_MVAE_METRICS = os.path.join(REPO, "artifacts", "tennis_hit", "mvae_metrics.jsonl")


def _jax_rows(path, epochs, keys):
    """The JAX package's committed TPU run's rows at `epochs` (a JSON line
    per epoch), for printing beside the port's."""
    rows = {r["epoch"]: r for r in map(json.loads, open(path))}
    return {e: {k: rows[e][k] for k in keys if k in rows[e]} for e in epochs}


def _all_finite(what, rows) -> None:
    import math

    for i, r in enumerate(rows):
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            fail(f"{what}: epoch {i + 1}: non-finite {bad}")


def _learn_amass_im(dev, card: str):
    """L1: amass_im as `cli/run.py` `_build_im` builds it at 2048 envs, with
    `fused_optimizer="on"`, for LEARN_EPOCHS graphed epochs; K1 counted over
    all of them. Returns (agent, state, K1 launches)."""
    import dataclasses

    import numpy as np
    import torch

    from vid2player3d_torch.cli import run as R
    from vid2player3d_torch.cli.configs import CONFIGS

    t0 = time.perf_counter()
    run_cfg = CONFIGS["amass_im"]
    run_cfg = dataclasses.replace(run_cfg, ppo=dataclasses.replace(run_cfg.ppo,
                                                                   fused_optimizer="on"))
    args = R.build_parser().parse_args(["--cfg", "amass_im", "--num_envs", str(LEARN_ENVS)])
    agent = R._build_im(run_cfg, args, dev)
    if not agent.graphed:
        fail("learn L1: the learner does not take the graphs")
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = agent.num_minibatches * agent.cfg.mini_epochs

    _zero_kernel_counts()
    rows, epoch_s, captures = [], [], []
    for _ in range(LEARN_EPOCHS):
        before = _captures(agent)
        ts, m, s = _timed_epoch(agent.train_epoch, ts)
        captures.append(_captures(agent) - before)
        epoch_s.append(s)
        rows.append({k: float(v) for k, v in m.items()})
    c = _kernel_counts()
    launches = {"update": c["k1_update"], "norm": c["k1_norm"]}

    _all_finite("learn L1", rows)
    alive = np.array([r["alive_ratio"] for r in rows])
    c_loss = np.array([r["c_loss"] for r in rows])
    gain = float(alive[-10:].mean() - alive[:10].mean())
    c_frac = float(c_loss[5:10].mean() / c_loss[0])
    want = LEARN_EPOCHS * steps
    graphs = {g: _graph_stats(getattr(agent._st, g)) for g in ("step", "update")}
    rest = epoch_s[1:]
    say("learn_L1", card=card, nvidia_smi=nvidia_smi(), cfg="amass_im (cli/run.py _build_im)",
        envs=LEARN_ENVS, epochs=LEARN_EPOCHS, cut=f"500 -> {LEARN_EPOCHS} epochs",
        fused_optimizer="on", compute_dtype=str(agent.compute_dtype),
        optimizer_steps_per_epoch=steps, setup_s=setup_s, first_epoch_s=epoch_s[0],
        epoch_s_after_first={"mean": sum(rest) / len(rest), "min": min(rest), "max": max(rest)},
        total_s=sum(epoch_s), k1_launches=launches,
        captures_per_epoch={"first": captures[0], "later": sum(captures[1:])},
        graphs=graphs,
        alive_gain=gain, alive_gain_min=LEARN_ALIVE_GAIN,
        alive_first10=float(alive[:10].mean()), alive_last10=float(alive[-10:].mean()),
        c_loss_frac=c_frac, c_loss_frac_max=LEARN_CLOSS_FRAC,
        port_rows={e: {k: rows[e - 1][k] for k in LEARN_ROW_KEYS} for e in LEARN_JAX_EPOCHS
                   if e <= LEARN_EPOCHS},
        jax_v5e_rows=_jax_rows(JAX_AMASS_METRICS, LEARN_JAX_EPOCHS, LEARN_ROW_KEYS),
        alive_every_10=[float(alive[i:i + 10].mean()) for i in range(0, LEARN_EPOCHS, 10)])
    if launches != {"update": want, "norm": want}:
        fail(f"learn L1: K1 launched {launches}, expected {want} each (2 per optimizer step)")
    if int(ts.opt_state.count) != want:
        fail(f"learn L1: optimizer count {int(ts.opt_state.count)}, expected {want}")
    if any(graphs[g]["captures"] != 1 for g in ("step", "update")) or any(captures[1:]):
        fail(f"learn L1: captures per epoch {captures}")
    if not gain >= LEARN_ALIVE_GAIN:
        fail(f"learn L1: alive_ratio rose by {gain} (epochs 1-10 to the last 10), "
             f"not {LEARN_ALIVE_GAIN}")
    if not c_frac <= LEARN_CLOSS_FRAC:
        fail(f"learn L1: c_loss over epochs 6-10 is {c_frac} of epoch 1's")
    return agent, ts, launches


def _learn_eval(dev, card: str, agent, ts) -> None:
    """L2: `eval_imitation` (graphed) of the trained parameters against the
    initial ones (pure-PD parity: the small-init residual heads) at 2048
    envs, both on the same fed reset times."""
    import math

    import torch

    from vid2player3d_torch.data import motion_lib as ML
    from vid2player3d_torch.eval import eval_imitation

    env = agent.env
    gen = torch.Generator(dev).manual_seed(1234)
    trunc = env.cfg.context_length * env.cfg.control_dt
    draws = {"motion_times": torch.stack([
        ML.sample_time(env.lib, env.motion_ids, truncate_time=trunc, generator=gen)
        for _ in range(LEARN_EVAL_ROLLOUTS)])}
    reports, secs = {}, {}
    for name, state in (("trained", ts), ("initial", agent.init_state())):
        t0 = time.perf_counter()
        reports[name] = eval_imitation(agent, num_rollouts=LEARN_EVAL_ROLLOUTS, ts=state,
                                       draws=draws)
        secs[name] = time.perf_counter() - t0
    say("learn_L2", card=card, envs=env.cfg.num_envs, rollouts=LEARN_EVAL_ROLLOUTS,
        graphed=agent.graphed, eval_s=secs, trained=reports["trained"],
        initial=reports["initial"])
    for name, rep in reports.items():
        if not all(math.isfinite(v) for v in rep.values()):
            fail(f"learn L2: the {name} evaluation is not finite: {rep}")
    if not reports["trained"]["success_rate"] > reports["initial"]["success_rate"]:
        fail(f"learn L2: trained success_rate {reports['trained']['success_rate']} not above "
             f"the initial {reports['initial']['success_rate']}")


def _learn_stage1(dev, card: str, pi_low, gen):
    """L5: the trained pi_low embedded in federer_train_stage_1 at its 10,240
    envs, two graphed epochs: finite, grad_skip 0, K2 3 + 3 and K3 2 per env
    step through the replays. Returns the launches of both epochs."""
    import torch

    t0 = time.perf_counter()
    agent = _stage1_agent(dev, TENNIS_ENVS, gen=gen, pi_low=pi_low)
    ts = agent.init_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = {"moe_linear": 3 * TENNIS_HORIZON, "moe_split_w": 3 * TENNIS_HORIZON,
            "fk_chain": 2 * TENNIS_HORIZON}
    ts, epoch_s, rollout_s, rows, launches, graphs, peak_gib = _graphed_epochs(
        "learn L5", agent, ts, LEARN_STAGE1_EPOCHS, want)
    keep = ("reward_mean", "contact_rate", "racket_ball_dist", "done_rate", "c_loss", "kl",
            "grad_skip")
    say("learn_L5", card=card, envs=TENNIS_ENVS, epochs=LEARN_STAGE1_EPOCHS,
        pi_low="learn_L1's trained amass_im checkpoint", setup_s=setup_s, epoch_s=epoch_s,
        rollout_s=rollout_s, launches_per_epoch=launches, peak_mem_gib=peak_gib,
        captures_per_epoch=graphs["captures_per_epoch"],
        metrics=[{k: r[k] for k in keep} for r in rows])
    return {k: sum(x[k] for x in launches) for k in want}


def _tracking_error(agent, ts, policy: bool, seed: int = 7, steps: int = TRACK_STEPS) -> float:
    """tests/test_pi_low.py's tracking error: the mean body-position error
    (m) over the alive envs of `steps` deterministic steps from one fixed
    reset, of the policy's mean action or of pure PD of the reference dofs
    with zero residuals (the tennis env's `pi_low=None` fallback)."""
    import numpy as np
    import torch

    from vid2player3d_torch.data import motion_lib as ML
    from vid2player3d_torch.physics import engine

    env = agent.env
    n = env.cfg.num_envs
    state, raw_obs, ctx = env.reset_all(generator=torch.Generator(env.device).manual_seed(seed))
    errs = []
    with torch.no_grad():
        for t in range(steps):
            if policy:
                act = agent._forward(ts.params, ts.obs_norm, raw_obs, ctx["feat"], t)[2]
            else:
                c_dof = agent._ctx_frame(ctx["feat"], t)[2]
                act = torch.cat([c_dof, torch.zeros(n, 6, device=env.device)], dim=-1)
            state, out = env.step(state, act)
            raw_obs = out.obs
            tar = ML.get_motion_state(env.lib, env.motion_ids, state.motion_times,
                                      adjust_height=True)
            bp = engine.fk_world(env.model, state.sim)[0]
            err = torch.linalg.norm(tar["rb_pos"] - bp, dim=-1).mean(-1)
            errs.append(torch.where(state.reset_buf == 0, err, torch.nan))
    return float(np.nanmean(torch.stack(errs).cpu().numpy()))


def _learn_tracking(dev, card: str, d: str):
    """L3: tests/test_pi_low.py::test_trained_pi_low_beats_pure_pd_tracking
    at its own size on the card (64 envs, 4 motions x 90 frames, horizon 16,
    minibatch 256, 4 mini-epochs, constant lr 1e-4, 5 x 5 graphed epochs,
    with K1): the error every 5 epochs must fall by 0.005, end at or below
    the first two points and below pure PD's; the checkpoint through
    `FrozenImitator` gives the learner's mean action. Returns K1's
    launches."""
    import math

    import torch

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, PPOConfig

    t0 = time.perf_counter()
    lib = make_synthetic_motion_lib(num_motions=4, T=90, fps=30.0, seed=0, device=dev)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=TRACK_ENVS, substeps=2), lib, rng=0, device=dev)
    agent = ImitationPPO(env, PPOConfig(horizon=16, minibatch_size=256, mini_epochs=4,
                                        learning_rate=1e-4, lr_schedule="constant",
                                        fused_optimizer="on"), seed=3, device=dev)
    if not agent.graphed:
        fail("learn L3: the learner does not take the graphs")
    ts = agent.init_state()
    _zero_kernel_counts()
    curve = [_tracking_error(agent, ts, True)]
    for _ in range(TRACK_BLOCKS):
        for _ in range(TRACK_EPOCHS_PER_BLOCK):
            ts, _ = agent.train_epoch(ts)
        curve.append(_tracking_error(agent, ts, True))
    err_pd = _tracking_error(agent, ts, False)
    c = _kernel_counts()
    launches = {"update": c["k1_update"], "norm": c["k1_norm"]}
    path = os.path.join(d, "track.npz")
    agent.save_checkpoint(path, ts)
    frozen = FrozenImitator.from_checkpoint(path, device=dev)
    _, raw_obs, ctx = env.reset_all(generator=torch.Generator(dev).manual_seed(7))
    with torch.no_grad():
        io, _, mu, _, c_dof = agent._forward(ts.params, ts.obs_norm, raw_obs, ctx["feat"], 0)
        mu_f = frozen(io)
    mu_f = torch.cat([mu_f[:, :69] + c_dof, mu_f[:, 69:]], dim=-1)
    frozen_err = float((mu_f - mu).abs().max())
    epochs = TRACK_BLOCKS * TRACK_EPOCHS_PER_BLOCK
    want = epochs * agent.num_minibatches * agent.cfg.mini_epochs
    say("learn_L3", card=card, envs=TRACK_ENVS, epochs=epochs, curve=curve, err_pd=err_pd,
        k1_launches=launches, frozen_mu_max_abs_err=frozen_err,
        frozen_note="the learner's trunk in bf16, the frozen net in f32",
        captures={g: getattr(agent._st, g).captures for g in ("step", "update")},
        phase_s=time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in curve + [err_pd, frozen_err]):
        fail(f"learn L3: non-finite curve {curve}, pure PD {err_pd}")
    if not curve[-1] < curve[0] - 0.005:
        fail(f"learn L3: no learning: {curve}")
    if not curve[-1] <= min(curve[:2]):
        fail(f"learn L3: curve not improving: {curve}")
    if not curve[-1] < err_pd:
        fail(f"learn L3: the trained policy {curve[-1]} does not beat pure PD {err_pd}")
    if launches != {"update": want, "norm": want}:
        fail(f"learn L3: K1 launched {launches}, expected {want} each")
    if not frozen_err <= 2e-3:
        fail(f"learn L3: FrozenImitator's mean action differs by {frozen_err}")
    if (agent._st.step.captures, agent._st.update.captures) != (1, 1):
        fail("learn L3: the graphs were captured more than once")
    return launches


def _learn_mvae(dev, card: str, ds_dir: str, keep: str):
    """L4: mvae_federer on the `data` phase's generated dataset for
    LEARN_MVAE_EPOCHS epochs of the config's windows, each window replayed
    from its graph: recon at the last epoch at most LEARN_MVAE_FRAC of epoch
    1's; K2 3 prep + 3 GEMM per
    optimizer step. The trained MotionVAE is saved where the command line's
    tennis configs look for it under `keep` (`keep/mvae_federer`). Returns
    K2's launches."""
    import math

    import torch

    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer
    from vid2player3d_torch.mvae.dataset import load_video_dataset
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

    t0 = time.perf_counter()
    opt = MVAEOption.load("federer")
    opt.checkpoint_dir, opt.model_ver = keep, "mvae_federer"
    trainer = MVAETrainer(opt, load_video_dataset(opt, ds_dir), device=dev)
    setup_s = time.perf_counter() - t0
    MOE.moe_linear.launches = MOE.split_weights.launches = 0
    rows, epoch_s = [], []
    for _ in range(LEARN_MVAE_EPOCHS):
        t0 = time.perf_counter()
        rows.append(trainer.train_epoch())
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    launches = {"moe_split_w": MOE.split_weights.launches, "moe_linear": MOE.moe_linear.launches}
    steps = int(trainer.opt_state.count)
    nb = opt.nseqs // opt.batch_size
    frac = rows[-1]["recon"] / rows[0]["recon"]
    say("learn_L4", card=card, cfg="mvae_federer", dataset=os.path.basename(ds_dir),
        windows_per_epoch=nb, epochs=LEARN_MVAE_EPOCHS, optimizer_steps=steps,
        setup_s=setup_s, epoch_s=epoch_s, ms_per_optimizer_step=sum(epoch_s) / steps * 1e3,
        k2_launches=launches, recon_frac=frac, recon_frac_max=LEARN_MVAE_FRAC, port_rows=rows,
        jax_v5e_rows=_jax_rows(JAX_MVAE_METRICS, (1, LEARN_MVAE_EPOCHS),
                               ("recon", "kl", "recon_phase")))
    _all_finite("learn L4", rows)
    want = LEARN_MVAE_EPOCHS * nb * _mvae_steps_per_window()
    if steps != want or launches != {"moe_split_w": 3 * steps, "moe_linear": 3 * steps}:
        fail(f"learn L4: {steps} optimizer steps (expected {want}) launched K2 {launches}")
    if not math.isfinite(frac) or not frac <= LEARN_MVAE_FRAC:
        fail(f"learn L4: recon at epoch {LEARN_MVAE_EPOCHS} is {frac} of epoch 1's")
    trainer.save_checkpoint("latest")
    return launches


def learn_phase(dev, card: str, ds_dir: str, gen, keep: str):
    """The JAX package's learning checks, through the graphed trainers at
    full width (L1-L5 above; each fails the script when it is not met), in
    a directory under build/. `ds_dir` (the `data` phase's generated tennis
    dataset) is removed after. L1's policy (`keep/amass_im.npz`) and L4's
    MotionVAE (`keep/mvae_federer/`) are kept for the `hit` phase. Returns
    the kernels' launches per check."""
    import shutil

    from vid2player3d_torch.learn import FrozenImitator

    d = os.path.join(REPO, "build", f"learn_smoke_{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    try:
        agent, ts, k1_l1 = _learn_amass_im(dev, card)
        _learn_eval(dev, card, agent, ts)
        path = os.path.join(d, "amass_im.npz")
        agent.save_checkpoint(path, ts)
        del agent, ts
        k2k3_l5 = _learn_stage1(dev, card, FrozenImitator.from_checkpoint(path, device=dev), gen)
        k1_l3 = _learn_tracking(dev, card, d)
        k2_l4 = _learn_mvae(dev, card, ds_dir, keep)
        shutil.copy(path, os.path.join(keep, "amass_im.npz"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(ds_dir, ignore_errors=True)
    say("learn", card=card, nvidia_smi=nvidia_smi(), phase_s=time.perf_counter() - t0,
        checks="L1-L5 met")
    return {"k1_amass_im": k1_l1, "k1_tracking": k1_l3, "k2_mvae": k2_l4, "stage1": k2k3_l5}


# ---------------------------------------------------------------------------
# phase 26c: the system's own scripts (vid2player3d_torch/scripts)
# ---------------------------------------------------------------------------

# the curriculum cut to a smoke: 10 imitation epochs (its learning checks
# apply from 300), the MotionVAE's 5 pre-run epochs of 2 windows, stage 1
# for 2 epochs; the evaluations at the script's own sizes
SCRIPTS_E2E = {"im_epochs": 10, "mvae_batches": 2, "stage1_epochs": 2}
SWING_N, SWING_SEED = 8, 3          # swing_quality's defaults
JAX_E2E_REPORT = os.path.join(REPO, "artifacts", "e2e", "e2e_report.json")


def _scripts_swing(dev) -> dict:
    """swing_quality at its defaults on the card, held to the same call on
    the CPU: the contacts equal, the speeds to 1e-4 relative, the rates
    within one ball (each side flies the balls in float32)."""
    from vid2player3d_torch.scripts import swing_quality as SQ

    t0 = time.perf_counter()
    got = SQ.swing_quality(SWING_N, seed=SWING_SEED, device=dev)
    secs = time.perf_counter() - t0
    ref = SQ.swing_quality(SWING_N, seed=SWING_SEED, device="cpu")
    if got["contacts"] != ref["contacts"] or not got["contacts"]:
        fail(f"scripts swing_quality: contacts {got['contacts']} on the card, "
             f"{ref['contacts']} on the CPU")
    for k in ("head_speed_mean", "out_speed_mean", "out_vz_p50"):
        if abs(got[k] - ref[k]) > 1e-4 * abs(ref[k]):
            fail(f"scripts swing_quality: {k} {got[k]} on the card, {ref[k]} on the CPU")
    for k in ("net_clear", "bounce_in"):
        if abs(got[k] - ref[k]) > 1.0 / ref["contacts"] + 1e-12:
            fail(f"scripts swing_quality: {k} {got[k]} on the card, {ref[k]} on the CPU")
    return {"card": got, "cpu": ref, "card_s": secs, "report": SQ.format_report(got)}


def _check_e2e_report(rep: dict) -> None:
    import math

    with open(JAX_E2E_REPORT) as f:
        ref = json.load(f)
    if set(rep) != set(ref):
        fail(f"scripts e2e: report keys {sorted(rep)}, the JAX artifact's {sorted(ref)}")
    for k, v in ref.items():
        if isinstance(v, dict):
            if set(rep[k]) != set(v):
                fail(f"scripts e2e: {k} keys {sorted(rep[k])}, the JAX artifact's {sorted(v)}")
            bad = {n: x for n, x in rep[k].items() if not math.isfinite(x)}
            if bad:
                fail(f"scripts e2e: {k} not finite: {bad}")


def scripts_phase(dev, card: str) -> dict:
    """`swing_quality` on the card against the CPU, then the curriculum
    script `e2e_curriculum` at a cut depth in a directory under build/
    (removed after): every leg exits 0, the report has the JAX artifact's
    keys and finite numbers, the HTML is written. The kernels' counters are
    set to 0 just before the curriculum and read just after; K2 and K3 must
    have launched."""
    import contextlib
    import io
    import shutil

    import torch

    from vid2player3d_torch.scripts import e2e_curriculum as E2E

    t0 = time.perf_counter()
    swing = _scripts_swing(dev)
    d = os.path.join(REPO, "build", f"scripts_e2e_{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    buf = io.StringIO()
    try:
        _zero_kernel_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rep = E2E.main(d, device=dev, **SCRIPTS_E2E)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t1
        counts = _kernel_counts()
        _check_e2e_report(rep)
        html = os.path.join(d, rep["render"])
        if not os.path.exists(html) or os.path.getsize(html) == 0:
            fail(f"scripts e2e: no {html}")
        html_bytes = os.path.getsize(html)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for k in ("k2_prep", "k2_gemm", "k3"):
        if counts[k] == 0:
            fail(f"scripts e2e: {k} never launched ({counts})")
    say("scripts", card=card, nvidia_smi=nvidia_smi(), swing_quality=swing,
        e2e_depth=SCRIPTS_E2E, e2e_s=e2e_s,
        e2e_legs=[ln for ln in buf.getvalue().splitlines() if ln.startswith("[")],
        e2e_report=rep, html_bytes=html_bytes, launches=counts,
        phase_s=time.perf_counter() - t0)
    return {"moe_split_w": counts["k2_prep"], "moe_linear": counts["k2_gemm"],
            "fk_chain": counts["k3"], "norm": counts["k1_norm"], "update": counts["k1_update"]}


# ---------------------------------------------------------------------------
# phase 26d: the hitting curriculum through the command line, and its checks
# ---------------------------------------------------------------------------

# the keys of the JAX package's tennis evaluation reports
HIT_EVAL_KEYS = ("cycles", "hit_rate", "bounce_in_rate", "bounce_pos_error", "fh_ratio",
                 "reward_mean")
# H1-H4's thresholds (artifacts/torch_tennis_hit/README.md): half of the JAX
# package's committed TPU runs' figures
HIT_LAST = 50
HIT_FIRST = 10
HIT_LEG_MIN = {"stage1a": 0.021, "stage1": 0.010, "stage2a": 0.029}
HIT_EVAL_MIN = {"stage1_full": 0.010, "stage2a_narrow": 0.026, "stage2a_full": 0.011}
HIT_EVAL_CYCLES = 1500
HIT_OVER_BASELINE = 3.0
SERVE_LAST, SERVE_MIN = 20, 0.015


def _mean_of(rows, key, part) -> float:
    vals = [float(r[key]) for r in rows[part]]
    return sum(vals) / len(vals)


def _report_ok(rep: dict) -> bool:
    """H5 on one evaluation report: exactly the JAX report's keys, and
    `bounce_pos_error` null exactly when nothing bounced in."""
    return (set(rep) == set(HIT_EVAL_KEYS)
            and (rep["bounce_pos_error"] is None) == (rep["bounce_in_rate"] == 0))


def _rows_ok(rows) -> list:
    """H6 on one leg's metric rows: the (epoch, key) of every non-finite
    value and of every row that logs a skipped update."""
    import math

    bad = []
    for r in rows:
        for k, v in r.items():
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                bad.append((r.get("epoch"), k))
        if r.get("grad_skip", 0.0) != 0.0:
            bad.append((r.get("epoch"), "grad_skip"))
    return bad


def hit_checks(legs: dict, evals: dict, baseline=None) -> dict:
    """H1-H6 of artifacts/torch_tennis_hit/README.md on the curriculum's
    metric rows (`legs`: "stage1a", "stage1", "stage2a", and any other leg
    for H6) and evaluation reports (`evals`: "stage1_full",
    "stage2a_narrow", "stage2a_full"; `baseline`: the untrained stage-1a
    policy's on the narrow spread, or None, which leaves H4's 3x clause
    out). Returns {check: {"met": bool, "value": ..., ...}}."""
    res = {}
    s1a = legs["stage1a"]
    first, last = (_mean_of(s1a, "hit_rate", slice(0, HIT_FIRST)),
                   _mean_of(s1a, "hit_rate", slice(-HIT_LAST, None)))
    res["H1"] = dict(met=last >= HIT_LEG_MIN["stage1a"] and last > first, value=last,
                     first10=first, min=HIT_LEG_MIN["stage1a"])
    last = _mean_of(legs["stage1"], "hit_rate", slice(-HIT_LAST, None))
    res["H2"] = dict(met=last >= HIT_LEG_MIN["stage1"], value=last, min=HIT_LEG_MIN["stage1"])
    s2a = legs["stage2a"]
    last = _mean_of(s2a, "hit_rate", slice(-HIT_LAST, None))
    q_first, q_last = (_mean_of(s2a, "quality_reward", slice(0, HIT_FIRST)),
                       _mean_of(s2a, "quality_reward", slice(-HIT_LAST, None)))
    res["H3"] = dict(met=last >= HIT_LEG_MIN["stage2a"] and q_last > q_first, value=last,
                     min=HIT_LEG_MIN["stage2a"], quality_first10=q_first, quality_last50=q_last)
    per = {}
    for name, lo in HIT_EVAL_MIN.items():
        rep = evals[name]
        ok = rep["hit_rate"] >= lo and rep["cycles"] >= HIT_EVAL_CYCLES
        if baseline is not None:
            ok = ok and rep["hit_rate"] >= HIT_OVER_BASELINE * baseline["hit_rate"]
        per[name] = dict(met=ok, hit_rate=rep["hit_rate"], cycles=rep["cycles"], min=lo)
    res["H4"] = dict(met=all(p["met"] for p in per.values()), value=per,
                     baseline=None if baseline is None else baseline["hit_rate"])
    reports = dict(evals, **({} if baseline is None else {"baseline": baseline}))
    bad = sorted(n for n, rep in reports.items() if not _report_ok(rep))
    res["H5"] = dict(met=not bad, value=bad)
    bad = {n: _rows_ok(rows)[:5] for n, rows in legs.items() if _rows_ok(rows)}
    res["H6"] = dict(met=not bad, value=bad)
    return res


def serve_checks(rows, report: dict) -> dict:
    """S1-S3 of serve practice (artifacts/torch_serve_practice/README.md):
    the mean hit_rate over the last 20 epochs, H5 on its evaluation, H6 on
    its rows."""
    last = _mean_of(rows, "hit_rate", slice(-SERVE_LAST, None))
    return {"S1": dict(met=last >= SERVE_MIN, value=last, min=SERVE_MIN),
            "S2": dict(met=_report_ok(report), value=report),
            "S3": dict(met=not _rows_ok(rows), value=_rows_ok(rows)[:5])}


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def score_hit_artifacts(hit_dir: str, serve_dir: str) -> dict:
    """H1-H6 and S1-S3 on the files of artifacts/torch_tennis_hit/ and
    artifacts/torch_serve_practice/ (the names their READMEs give):

        python3 -c "import chip_smoke as C, json; print(json.dumps(
            C.score_hit_artifacts('artifacts/torch_tennis_hit',
                                  'artifacts/torch_serve_practice'), indent=1))"
    """
    def rep(d, name):
        with open(os.path.join(d, name)) as f:
            return json.load(f)

    legs = {k: _jsonl(os.path.join(hit_dir, f"{k}_metrics.jsonl"))
            for k in ("mvae", "amass_im", "im", "stage1a", "stage1", "stage2a")}
    evals = {"stage1_full": rep(hit_dir, "stage1_eval_report.json"),
             "stage2a_narrow": rep(hit_dir, "stage2a_eval_report.json"),
             "stage2a_full": rep(hit_dir, "stage2a_eval_report_full_spread.json")}
    out = hit_checks(legs, evals, baseline=rep(hit_dir, "untrained_eval_report.json"))
    out.update(serve_checks(_jsonl(os.path.join(serve_dir, "metrics.jsonl")),
                            rep(serve_dir, "eval_report.json")))
    return out


def reward_blocks(rows, block: int = 50) -> dict:
    """A stage-1 run's `reward_mean` as artifacts/torch_tennis_chain/README.md
    reads it: the means over epochs 1-100 and 151-250, their ratio, the
    50-epoch blocks, and the same of `hit_rate`."""
    def mean(key, lo, hi):
        vals = [float(r[key]) for r in rows[lo:hi]]
        return sum(vals) / len(vals)

    out = {}
    for key in (k for k in ("reward_mean", "hit_rate") if k in rows[0]):
        a, b = mean(key, 0, 100), mean(key, 150, 250)
        out[key] = dict(first100=a, last100=b, ratio=b / a,
                        blocks=[mean(key, i, i + block) for i in range(0, len(rows), block)])
    return out


# the curriculum cut to a smoke: stage 1a at its artifact's 2048 envs for 3
# epochs, stage 1 for 1 from its checkpoint, stage 2a and serve practice
# (at its artifact's 4096 envs) for 1 each by their configs' warm start, the
# evaluation of the 2a checkpoint at 1024 envs for 64 steps
HIT_ENVS, HIT_SERVE_ENVS, HIT_EVAL_ENVS = 2048, 4096, 1024
HIT_LEGS = (("stage1a", "federer_train_stage_1a", HIT_ENVS, 3, False),
            ("stage1", "federer_train_stage_1", HIT_ENVS, 1, False),
            ("stage2a", "federer_train_stage_2a", HIT_ENVS, 1, False),
            ("serve", "federer_train_serve", HIT_SERVE_ENVS, 1, False),
            ("eval_stage2a", "federer_train_stage_2a", HIT_EVAL_ENVS, 1, True))
# the narrow spread's bounce box around the player's start
HIT_NARROW_X = 1.0


def _hit_bounce_x(what, agent) -> dict:
    """Every ball the env can launch (its pool; reaction balls are pool rows)
    bounces within HIT_NARROW_X of the player's start box centre in x, its
    flight simulated again from the launch state."""
    import torch

    from vid2player3d_torch.tennis import ball as B

    env = agent.env
    gen = env.gen
    with torch.no_grad():
        res = B.simulate_flight(gen.launch_pos, gen.launch_vel, gen.launch_vspin,
                                num_frames=gen.traj_length, p=env.ball_params)
    dx = res.bounce_pos[:, 0] - env._root_xy_center[0]
    worst = float(dx.abs().max())
    if not bool(res.has_bounce.all()) or not worst <= HIT_NARROW_X:
        fail(f"hit {what}: a pool ball bounces {worst} m from the player's start x "
             f"(bounced: {int(res.has_bounce.sum())} of {gen.pool_size})")
    return dict(pool=gen.pool_size, max_abs_dx=worst)


def _hit_serve_toss(agent) -> dict:
    """The serve-toss reset: every env's ball starts 0.1 m above its free
    hand (the hand of the humanoid snapped to the reset pose)."""
    import torch

    from vid2player3d_torch.physics import engine

    env = agent.env
    with torch.no_grad():
        state, _ = env.reset_all()
        bp, _, _, _ = engine.fk_world(env.model, state.sim)
    hand = bp[torch.arange(env.cfg.num_envs, device=bp.device), env.free_hand_id]
    d = state.ball_pos - hand
    xy, dz = float(d[:, :2].abs().max()), d[:, 2]
    if not xy <= 1e-5 or not bool((dz > 0.05).all()):
        fail(f"hit serve: the tossed ball is not above the free hand (xy {xy}, "
             f"dz {float(dz.min())}..{float(dz.max())})")
    return dict(envs=env.cfg.num_envs, max_xy=xy, dz_min=float(dz.min()), dz_max=float(dz.max()))


def _hit_k3_cold(args, warm: dict) -> dict:
    """K3 at the path's N on copies of one step's inputs taken in turn
    (together over 4x the L2, so every call reads and writes device
    memory), eager and as a graph, beside the bound of `warm` (`_k3_small`
    on the same inputs)."""
    import math

    from vid2player3d_torch.ops import fk as FK

    sets = max(4, math.ceil(K3_COLD_BYTES / warm["bytes"]))
    ins = [tuple(a.clone() for a in args[:3]) + (args[3],) for _ in range(sets)]
    turn = [0]

    def cold():
        k = turn[0] % sets
        turn[0] += 1
        FK.fk_chain(*ins[k])

    graph_ms = _graph_ms(lambda: [FK.fk_chain(*a) for a in ins],
                         math.ceil(K3_TIMED / sets)) / sets
    return dict(cold_sets=sets, ms=cuda_ms(cold, sets * math.ceil(K3_TIMED / sets)),
                graph_ms=graph_ms, share_of_bound=warm["bound_ms"] / graph_ms)


def _hit_kernels(what, card, agent, k3_cold=False) -> dict:
    """K2 (and K3 when `k3_cold`) on one eager step of the agent's env from a
    fresh reset, held to their plain versions and timed at the env's size;
    the launches are not the path's."""
    import torch

    from vid2player3d_torch.ops import fk as FK

    before = _kernel_counts()
    n = agent.env.cfg.num_envs
    ts = agent.init_state()
    with torch.no_grad():
        mu, _ = agent._forward(ts.params, ts.obs_norm, ts.last_obs)
    out = _hold_k2_k3_eval(f"hit {what}", card, agent.env, ts.env_state, mu, (n,),
                           (n,) if k3_cold else ())
    if k3_cold:
        warm = out[f"k3_N{n}"]
        warm["cold"] = _hit_k3_cold(_record_k2_k3(agent.env, ts.env_state, mu)[f"k3/{n}"], warm)
    MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")
    FK.fk_chain.launches, MOE.moe_linear.launches, MOE.split_weights.launches = (
        before["k3"], before["k2_gemm"], before["k2_prep"])
    return out


def hit_phase(dev, card: str, pi_low_path: str, mvae_dir: str) -> dict:
    """The hitting curriculum cut to a smoke (HIT_LEGS), each leg one
    `cli.run.main` call in a directory under build/ (removed after), on the
    `learn` phase's amass_im policy (`pi_low_path`) and MotionVAE
    (`mvae_dir`, found by every leg as the curriculum's `mvae_federer`):
    each leg's counters set to 0 just before its call and read just after,
    K2 3 + 3 per env step and K3 2 per env step plus one per reset (the
    learner's; the evaluation's own too); H6 on every training leg's rows,
    H5 on the evaluation's report; every stage-1a and 2a pool ball within
    1 m in x of the player's start; the serve toss above the free hand; K2
    at B = 2048, 4096 and 1024 and K3 at N = 2048 (cold) held to their
    plain versions and timed. Returns the kernels' launches per leg."""
    import contextlib
    import io
    import shutil

    import torch

    import vid2player3d_torch.cli.run as RUN

    d = os.path.join(REPO, "build", f"hit_smoke_{os.getpid()}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copytree(mvae_dir, os.path.join(d, "mvae_federer"))
    built, build = [], RUN._build_tennis

    def keep(*a, **kw):
        agent = build(*a, **kw)
        built.append(agent)
        return agent

    t0 = time.perf_counter()
    legs, launches, kernels, checks = {}, {}, {}, {}
    RUN._build_tennis = keep
    try:
        for name, cfg, envs, epochs, test in HIT_LEGS:
            argv = ["--cfg", cfg, "--num_envs", str(envs), "--epochs", str(epochs),
                    "--pi_low_checkpoint", pi_low_path, "--out", d]
            if name == "stage1":
                argv += ["--checkpoint", os.path.join(d, "federer_train_stage_1a", "best.npz")]
            if test:
                argv += ["--test", "--checkpoint",
                         os.path.join(d, "federer_train_stage_2a", "best.npz")]
            buf = io.StringIO()
            built.clear()
            _zero_kernel_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = RUN.main(argv)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t1
            counts = _kernel_counts()
            text = buf.getvalue()
            if rc != 0 or "no trained MVAE" in text or "no low-level imitation" in text:
                fail(f"hit {name}: rc {rc}, output {text[-2000:]}")
            agent = built[-1]
            horizon = agent.cfg.horizon
            steps, resets = (64 * epochs, 2) if test else (horizon * epochs, 1)
            want = {"k2_prep": 3 * steps, "k2_gemm": 3 * steps, "k3": 2 * steps + resets}
            got = {k: counts[k] for k in want}
            if got != want or counts["k1_update"] or counts["k1_norm"]:
                fail(f"hit {name}: launches {counts}, expected {want} and no K1")
            launches[name] = got
            row = dict(call_s=call_s, envs=envs, epochs=epochs, horizon=horizon, launches=got)
            if test:
                rep, _ = json.JSONDecoder().raw_decode(text[text.index("{\n"):])
                if not _report_ok(rep):
                    fail(f"hit {name}: report {rep} lacks the JAX keys or its "
                         "bounce_pos_error disagrees with bounce_in_rate")
                row["report"] = rep
            else:
                path = os.path.join(d, "metrics.jsonl")
                rows = _jsonl(path)
                os.remove(path)
                bad = _rows_ok(rows)
                if len(rows) != epochs or bad:
                    fail(f"hit {name}: {len(rows)} rows, non-finite or skipped: {bad}")
                legs[name] = rows
                row["last_row"] = rows[-1]
                # the next leg's warm start finds the checkpoints under the config's name
                os.makedirs(os.path.join(d, cfg), exist_ok=True)
                for f in ("best.npz", "latest.npz"):
                    os.replace(os.path.join(d, f), os.path.join(d, cfg, f))
            if name in ("stage1a", "stage2a"):
                checks[f"{name}_bounce_x"] = _hit_bounce_x(name, agent)
            if name == "serve":
                checks["serve_toss"] = _hit_serve_toss(agent)
            if name in ("stage1a", "serve", "eval_stage2a"):
                kernels[f"B{envs}"] = _hit_kernels(name, card, agent, k3_cold=name == "stage1a")
            checks[name] = row
            built.clear()
            del agent
    finally:
        RUN._build_tennis = build
        shutil.rmtree(d, ignore_errors=True)
    say("hit", card=card, nvidia_smi=nvidia_smi(), legs=checks, kernels=kernels,
        checks="H5 H6, the narrow spread's bounce x, the serve toss, K2/K3 launches met",
        phase_s=time.perf_counter() - t0)
    return {"launches": launches, "kernels": kernels}


# ---------------------------------------------------------------------------
# phase 26: the engine's public API and its physical properties
# ---------------------------------------------------------------------------

PHYS_ENVS = 4096            # the imitation path's env count
PHYS_PARITY_ENVS = 6        # tests/test_torch_physics.py's humanoid case
PHYS_MODES = ("free_root_wrench", "fixed_base", "extra_wrench")
PHYS_TIMED = 10
# the CPU parity tests' bounds: positions and quaternions, velocities
PHYS_POS_ATOL, PHYS_VEL_ATOL = 5e-6, 2e-4


def _physics_case(d):
    """tests/test_torch_physics.py's humanoid case on `d` (6 envs, self-
    collision on), built by the port from the same seeds: the model, the
    state, the PD targets, the root wrenches and test_torch_physics_api.py's
    extra wrenches."""
    import numpy as np
    import torch

    from vid2player3d_torch.core import quat as Q
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.physics.asset import build_humanoid_model
    from vid2player3d_torch.physics.model import ArticulationState

    n = PHYS_PARITY_ENVS
    rng = np.random.RandomState(0)
    betas = (rng.randn(n, 10) * 0.5).astype(np.float32)
    model = build_humanoid_model(S.make_synthetic_smpl(), betas, self_collision=True, device=d)
    aa = torch.tensor((rng.randn(n, 23, 3) * 0.3).astype(np.float32))
    root_q = np.tile([0.5, 0.5, 0.5, 0.5], (n, 1)) + rng.randn(n, 4) * 0.05
    host = dict(
        root_pos=torch.tensor((np.array([0.0, 0.0, 0.93]) + rng.randn(n, 3) * 0.02)
                              .astype(np.float32)),
        root_quat=Q.quat_normalize(torch.tensor(root_q, dtype=torch.float32)),
        root_vel=torch.tensor((rng.randn(n, 6) * 0.3).astype(np.float32)),
        joint_quat=Q.exp_map_to_quat(aa),
        joint_omega=torch.tensor((rng.randn(n, 23, 3) * 0.5).astype(np.float32)))
    pd = aa.reshape(n, -1) + torch.tensor((rng.randn(n, 69) * 0.2).astype(np.float32))
    rf = torch.tensor((rng.randn(n, 3) * 20).astype(np.float32))
    rt = torch.tensor((rng.randn(n, 3) * 20).astype(np.float32))
    rng = np.random.RandomState(2)
    ef = torch.tensor((rng.randn(n, 24, 3) * 10).astype(np.float32))
    et = torch.tensor((rng.randn(n, 24, 3) * 2).astype(np.float32))
    state = ArticulationState(**{k: v.to(d) for k, v in host.items()})
    return model, state, {k: v.to(d) for k, v in
                          dict(pd=pd, rf=rf, rt=rt, ef=ef, et=et).items()}


def _physics_parity(dev) -> dict:
    """`substep` on the card against the CPU on the humanoid case: a free
    base with root wrenches, a fixed base, extra wrenches; 1 and 4
    substeps. Returns each case's largest position/quaternion and velocity
    errors."""
    from vid2player3d_torch.physics import engine

    cases = {str(d): _physics_case(d) for d in ("cpu", dev)}
    errs = {}
    for mode in PHYS_MODES:
        root, extra = mode != "extra_wrench", mode == "extra_wrench"
        states = {}
        for d, (model, state, x) in cases.items():
            for i in range(4):
                state = engine.substep(
                    model, state, x["pd"], x["rf"] if root else None, x["rt"] if root else None,
                    extra_force_w=x["ef"] if extra else None,
                    extra_torque_w=x["et"] if extra else None, fixed_base=mode == "fixed_base")
                states[(d, i + 1)] = state
        for k in (1, 4):
            ref, got = states[("cpu", k)], states[(str(dev), k)]
            pos = max(float((getattr(got, f).cpu() - getattr(ref, f)).abs().max())
                      for f in ("root_pos", "root_quat", "joint_quat"))
            vel = max(float((getattr(got, f).cpu() - getattr(ref, f)).abs().max())
                      for f in ("root_vel", "joint_omega"))
            errs[f"{mode}_{k}"] = {"pos_quat": pos, "vel": vel}
            if not (pos <= PHYS_POS_ATOL and vel <= PHYS_VEL_ATOL):
                fail(f"physics: substep {mode} x{k} on the card differs from the CPU's by "
                     f"{pos} (positions, quaternions; {PHYS_POS_ATOL}) and {vel} "
                     f"(velocities; {PHYS_VEL_ATOL})")
    return errs


def _per_call_ms(fn, iters: int = PHYS_TIMED) -> float:
    """Wall ms per call of `fn` on a synchronized host clock, after one
    warm-up call."""
    fn()
    _, seconds = _timed(lambda: [fn() for _ in range(iters)])
    return seconds / iters * 1e3


def physics_phase(dev, card: str) -> None:
    """The engine's public API on the card: `substep` held to the CPU on the
    humanoid case (a free base with root wrenches, a fixed base, extra
    wrenches; 1 and 4 substeps), then the five physical properties of
    tests/test_physics.py with its thresholds on every one of 4096 envs
    (free fall, momentum and the fixed-base pendulum on the two-body model;
    the drop-and-stand, 120 + 480 substeps at 1/240 s, and the self-
    collision deflection, 40 control steps of 4 substeps with collision off
    and on, on the synthetic-SMPL humanoid; each run's step replayed from a
    CUDA graph, `utils.graphs.StaticGraph`), and `substep`'s and
    `control_step(substeps=4)`'s ms per call at 4096 envs: eager on a
    synchronized host clock, and as a graph replay on CUDA events."""
    import numpy as np
    import torch

    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.physics import asset, engine, probes

    t_phase, secs, props = time.perf_counter(), {}, {}
    parity = _physics_parity(dev)
    secs["parity"] = time.perf_counter() - t_phase

    def run(name, fn):
        out, secs[name] = _timed(lambda: fn(PHYS_ENVS, dev))
        return out

    r = run("free_fall", probes.free_fall)
    rel = {k: float((r[k].double() - r[f"{k}_expected"]).abs().max()) / abs(r[f"{k}_expected"])
           for k in ("dz", "vz")}
    props["free_fall_max_rel_err"] = rel
    if not max(rel.values()) <= 1e-3:
        fail(f"physics: free fall off semi-implicit Euler's closed form by {rel} (1e-3)")

    r = run("momentum", probes.momentum)
    err = (r["p1"] - r["expected"]).abs() - 1e-7 * r["expected"].abs()
    props["momentum_max_abs_err"] = float(err.max())
    if not float(err.max()) <= 0.12:
        fail(f"physics: momentum drifts by {float(err.max())} (0.12)")

    r = run("pendulum", probes.pendulum)
    angles = r["angles"].cpu().numpy()
    full = np.abs(angles[-1] - r["theta0"]).max()
    half = np.abs(angles[r["steps"] // 2] + r["theta0"]).max()
    props["pendulum"] = {"substeps": r["steps"], "period_err": float(full),
                         "half_period_err": float(half)}
    if not (full < 0.02 and half < 0.02):
        fail(f"physics: pendulum off its period by {full} and {half} at half (0.02)")

    r = run("drop_and_stand", probes.drop_and_stand)
    st = r["state"]
    finite = all(bool(torch.isfinite(getattr(st, f)).all()) for f in
                 ("root_pos", "root_quat", "root_vel", "joint_quat", "joint_omega"))
    z_stand, z = r["root_pos_stand"][:, 2], st.root_pos[:, 2]
    vel = float(st.root_vel.abs().max())
    props["drop_and_stand"] = {"min_z_at_0_5s": float(z_stand.min()), "min_z": float(z.min()),
                               "max_z": float(z.max()), "max_abs_root_vel": vel}
    if not (finite and bool((z_stand > 0.8).all()) and bool((z > 0.02).all())
            and bool((z < 1.2).all()) and vel < 0.5):
        fail(f"physics: drop-and-stand {props['drop_and_stand']}, finite {finite}")

    r = run("self_collision", probes.self_collision_deflection)
    pen_off, pen_on = r["pen_off"], r["pen_on"]
    props["self_collision"] = {"min_pen_off": float(pen_off.min()),
                               "max_pen_on": float(pen_on.max()),
                               "min_deflection": float((pen_off - pen_on).min())}
    if not (bool(r["finite"]) and bool((pen_off > 0.05).all())
            and bool((pen_on < pen_off - 0.04).all())):
        fail(f"physics: self-collision {props['self_collision']}, finite {bool(r['finite'])}")

    ms = {}
    body = S.make_synthetic_smpl()
    for sc in (False, True):
        model = asset.build_humanoid_model(body, np.zeros((PHYS_ENVS, 10), np.float32),
                                           self_collision=sc, device=dev)
        state = asset.default_humanoid_state(model, PHYS_ENVS)
        pd = torch.zeros((PHYS_ENVS, model.num_dof), device=dev)
        key = "self_collision" if sc else "no_self_collision"
        step = (lambda: engine.substep(model, state, pd),
                lambda: engine.control_step(model, state, pd, substeps=4))
        ms[key] = {"substep": _per_call_ms(step[0]), "control_step_4": _per_call_ms(step[1]),
                   "substep_graph": _graph_ms(step[0], PHYS_TIMED),
                   "control_step_4_graph": _graph_ms(step[1], PHYS_TIMED)}
    say("physics", card=card, nvidia_smi=nvidia_smi(), envs=PHYS_ENVS,
        parity_envs=PHYS_PARITY_ENVS, parity_max_abs_err=parity,
        parity_atol={"pos_quat": PHYS_POS_ATOL, "vel": PHYS_VEL_ATOL}, properties=props,
        ms_per_call=ms, steps_s=secs, phase_s=time.perf_counter() - t_phase)


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
    k2 = k2_phase(dev, card)
    k3 = k3_phase(dev, card)
    parity_phase(dev)
    k1_launches, im_agent, im_ts, im_lib = main_phase(dev, card)
    graphs_phase(dev, card)
    tennis_parity_phase(dev)
    agent, ts, tennis_launches = tennis_main_phase(dev, card)
    stage2_env = stage2_phase(dev, card, agent, ts)
    ts, stage2_launches = tennis_graphs_phase(dev, card, agent, ts, stage2_env)
    dual_parity_phase(dev)
    dual_agent, dual_ts, dual_launches = dual_main_phase(dev, card)
    dual_graphs_phase(dev, card, dual_agent.env.gen)
    twohand_launches, k2_b30720 = twohand_main_phase(dev, card, agent.env.gen)
    dr_parity_phase(dev)
    ctx_parity_phase(dev)
    k1_dr = im_dr_main_phase(dev, card)
    k1_ctx = im_ctx_main_phase(dev, card)
    tennis_dr_launches = tennis_dr_main_phase(dev, card)
    ctx_dr_graphs_phase(dev, card)
    warm_launches = ckpt_phase(dev, card, agent, ts, stage2_env, dual_agent, im_agent, im_ts,
                               im_lib)
    del stage2_env, im_lib
    mvae_parity_phase(dev)
    mvae_launches, k2_b100 = mvae_main_phase(dev, card, agent, ts)
    eval_launches = eval_graphs_phase(dev, card, agent, ts, dual_agent, dual_ts, agent.env.gen)
    cli_launches = cli_phase(dev, card)
    # dp_parity and dp_cli only check: they run side by side, and their wall
    # times, printed as overlapped, measure nothing
    started = dp_cli_start()
    _beside(started, dp_parity_phase, dev, card)
    dp_cli_phase(dev, card, started)
    dp_launches = dp_main_phase(dev, card)
    learn_ds = os.path.join(REPO, "build", f"learn_ds_{os.getpid()}")
    data_launches = data_phase(dev, card, keep_dataset=learn_ds)
    hit_keep = os.path.join(REPO, "build", f"hit_keep_{os.getpid()}")
    os.makedirs(hit_keep, exist_ok=True)
    try:
        learn_launches = learn_phase(dev, card, learn_ds, agent.env.gen, hit_keep)
        scripts_launches = scripts_phase(dev, card)
        hit = hit_phase(dev, card, os.path.join(hit_keep, "amass_im.npz"),
                        os.path.join(hit_keep, "mvae_federer"))
    finally:
        import shutil

        shutil.rmtree(hit_keep, ignore_errors=True)
    physics_phase(dev, card)
    profile_phase(dev, card)
    rollout_profile_phase("tennis_profile", card, agent, ts)
    # one replayed dual step (~105 k device events eager, each step runs the
    # serve and the hand-off): cut from two, whose events took ~100 s to read
    # back
    rollout_profile_phase("dual_profile", card, dual_agent, dual_ts, horizon=1)

    b16, f32 = k1["bf16"], k1["f32"]   # bf16: the main path's moment type on the card
    k1_common = {"route": "cuda", "source": "vid2player3d_torch/csrc/fused_adam.cu",
                 "replaces": "vid2player3d_tpu/ops/fused_adam.py:66"}
    # K1 runs on four main paths (the imitation epochs, amass_im_dr's,
    # amass_im_corrupt's and amass_im's on the converted AMASS library); K2
    # and K3 on four (the stage-1 tennis epochs, the dual rally's, nadal's
    # two-hand epoch and federer_train_stage_1_dr's; the first three counted
    # through graph replays), K2 also on the MotionVAE trainer's (on the
    # synthetic pose dataset and, through the command line, on the generated
    # tennis dataset) and K3 on the warm-started stage-2 steps; the `learn`
    # phase runs K1 over LEARN_EPOCHS amass_im epochs and the 25 of the
    # tracking curve, K2 over LEARN_MVAE_EPOCHS MotionVAE epochs, K2 and K3 over 2 stage-1 epochs with the
    # trained pi_low; the `scripts` phase's curriculum K2 (the MotionVAE's
    # pre-run and random walk, the stage-1 decodes) and K3, and no K1 (its
    # imitation leg runs the optax chain). `launches` is K1's on the
    # imitation path and K2's and K3's on the dual path, each path's count
    # beside it
    # under data parallelism every rank launches the one-process count for
    # its share: `dp_*` is one rank's count of a two-rank epoch
    def dp_paths(key, names):
        return {f"dp_{n}_per_rank": dp_launches[n][key] for n in names}

    def k1_paths(kind):
        return {"launches_per_path": {
            "imitation": k1_launches[kind], "im_dr": k1_dr[kind], "im_ctx": k1_ctx[kind],
            "data_amass_im": data_launches["k1"][kind],
            f"learn_amass_im_{LEARN_EPOCHS}_epochs": learn_launches["k1_amass_im"][kind],
            "learn_tracking_25_epochs": learn_launches["k1_tracking"][kind],
            "scripts_e2e": scripts_launches[kind],
            **dp_paths("k1_" + kind, ("amass_im_per_minibatch", "amass_im_local_sgd"))}}

    def per_path(name):
        key = {"moe_linear": "k2_gemm", "moe_split_w": "k2_prep", "fk_chain": "k3"}[name]
        paths = {"tennis_stage1": tennis_launches[name], "tennis_stage2": stage2_launches[name],
                 "dual_rally": dual_launches[name], "two_hand_single": twohand_launches[name],
                 "tennis_stage1_dr": tennis_dr_launches[name], "cli": cli_launches[name],
                 "eval_stage1_graphed": eval_launches["stage1_full"][key],
                 "eval_dual_graphed": eval_launches["dual_full"][key]}
        if name in mvae_launches:
            paths["mvae_train"] = mvae_launches[name]
            paths["data_mvae"] = data_launches["k2"][name]
            paths[f"learn_mvae_{LEARN_MVAE_EPOCHS}_epochs"] = learn_launches["k2_mvae"][name]
        paths["learn_stage1_trained_pi_low_2_epochs"] = learn_launches["stage1"][name]
        paths["scripts_e2e"] = scripts_launches[name]
        paths.update({f"hit_{leg}": n[key] for leg, n in hit["launches"].items()})
        if name in warm_launches:
            paths["stage2_warm_start"] = warm_launches[name]
        paths.update(dp_paths(key, ("federer_train_stage_1", "nadal_federer")))
        return {"launches": dual_launches[name], "launches_per_path": paths}

    kernels = [
        {"name": "fused_adam_norm", **k1_common, "launches": k1_launches["norm"],
         **k1_paths("norm"),
         "max_abs_err": b16["scalar_rel_err"], "ms": b16["norm"], "plain_ms": b16["plain_norm"],
         "bound_ms": b16["norm_bound_ms"], "bound_by": "bytes", "library_ms": None,
         "unit": "the global norm and scalars of one ImitatorNet step (16 leaves); "
                 "max_abs_err is the scalars' largest relative error",
         "graph_ms": b16["norm_graph"], "plain_graph_ms": b16["plain_norm_graph"]},
        {"name": "fused_adam_update", **k1_common, "launches": k1_launches["update"],
         **k1_paths("update"),
         "max_abs_err": max(b16["err_p"], b16["err_moments"]), "ms": b16["update"],
         "plain_ms": b16["plain_update"], "bound_ms": b16["update_bound_ms"], "bound_by": "bytes",
         "library_ms": b16["library_ms"],
         "unit": "the update of one ImitatorNet step (16 leaves), bf16 moments; library: "
                 "torch.optim.Adam(fused=True), f32 moments",
         "graph_ms": b16["update_graph"], "plain_graph_ms": b16["plain_update_graph"],
         "library_graph_ms": b16["library_graph_ms"], "step_ms": b16["step"],
         "step_graph_ms": b16["step_graph"], "step_bound_ms": b16["step_bound_ms"],
         "host_ms_per_step": b16["host_ms_per_step"],
         "f32_moments": {k: f32[k] for k in ("err_p", "err_moments", "update", "update_graph",
                                             "step", "step_graph", "update_bound_ms",
                                             "step_bound_ms")}},
        {"name": "moe_split_w", "route": "cuda",
         "source": "vid2player3d_torch/csrc/moe_linear.cu",
         "replaces": "vid2player3d_tpu/ops/moe_linear.py:71",
         **per_path("moe_split_w"), "max_abs_err": k2["split_max_abs_err"],
         "ms": k2["split_ms"], "plain_ms": k2["plain_split_ms"], "bound_ms": k2["split_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "unit": "K2's prep: the TF32 split of the decoder's three W and biases, transposed",
         "graph_ms": k2["split_graph_ms"], "plain_graph_ms": k2["plain_split_graph_ms"]},
        {"name": "moe_linear", "route": "cuda", "source": "vid2player3d_torch/csrc/moe_linear.cu",
         "replaces": "vid2player3d_tpu/ops/moe_linear.py:71",
         **per_path("moe_linear"),
         **{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
         "unit": "one MVAE decode (3 prep + 3 GEMM launches) at B=10240, per_lane_B7680 "
                 "one lane's decode in the dual rally, stage2_B15360 the stage-2 decode, "
                 "two_hand_B30720 nadal's decode on its own inputs; bound: 3xTF32",
         "per_lane_B7680": k2["per_lane_B7680"], "stage2_B15360": k2["stage2_B15360"],
         "two_hand_B30720": k2_b30720,
         "mvae_B100": k2_b100,
         **{f"hit_{b}": row[f"k2_{b}"] for b, row in hit["kernels"].items()},
         "graph_ms": k2["graph_ms"], "plain_graph_ms": k2["plain_graph_ms"],
         "library_graph_ms": k2["library_graph_ms"], "f32_simt_bound_ms": k2["f32_simt_bound_ms"],
         "backward_max_abs_err": k2["backward_max_abs_err"]},
        {"name": "fk_chain", "route": "cuda", "source": "vid2player3d_torch/csrc/fk_chain.cu",
         "replaces": "vid2player3d_tpu/ops/fk.py:77",
         **per_path("fk_chain"),
         **{k: k3[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")},
         "unit": "one FK at N=10240 (N15360: the dual rally's and stage 2's; N30720: "
                 "nadal's and djokovic's); ms and graph_ms with cold inputs (sets over 4x the "
                 "L2 in turn), warm_ms and warm_graph_ms one set again and again",
         "N15360": k3["N15360"], "N30720": k3["N30720"],
         "hit_N2048": hit["kernels"][f"B{HIT_ENVS}"][f"k3_N{HIT_ENVS}"],
         "graph_ms": k3["graph_ms"], "warm_ms": k3["warm_ms"],
         "warm_graph_ms": k3["warm_graph_ms"], "plain_graph_ms": k3["plain_graph_ms"],
         "host_ms_per_call": k3["host_ms_per_call"], "share_of_bound": k3["share_of_bound"]},
    ]
    say("total", seconds=time.perf_counter() - t_start)
    print("nvidia-smi: " + nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
