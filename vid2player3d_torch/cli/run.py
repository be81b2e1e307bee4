"""Training / evaluation entry point (counterpart of ``vid2player3d_tpu/cli/run.py``).

    python -m vid2player3d_torch --cfg amass_im [--num_envs N] [--epochs E]
        [--seed S] [--checkpoint PATH] [--motion_file PATH] [--out DIR]
        [--test [--render OUT.html [--select_best]]] [--device DEV] [--n_devices D]

Training writes `metrics.jsonl` (one JSON line per epoch) and `latest.npz` /
`best.npz` checkpoints in the JAX package's layout into `--out`; a tennis
config finds its curriculum's earlier stages there (the player's imitation
policy, the MotionVAE, the warm-start stage). Everything runs on the card
unless `--device` names another device; with no card and no `--device` the
run raises.

`--n_devices D` trains data-parallel over D ranks (``parallel/``): under
torchrun the process joins its group; otherwise the command starts the D
ranks itself, one per visible card over NCCL, or D gloo ranks with
`--device cpu`. D larger than the visible cards raises. Rank 0 alone
prints, writes `--out`'s files and runs `--test`, which evaluates in one
process.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vid2player3d_torch",
                                description=__doc__.split("\n")[0])
    p.add_argument("--cfg", required=True, help="named config (see cli.configs)")
    p.add_argument("--test", action="store_true",
                   help="evaluation mode: deterministic rollouts + metrics")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--minibatch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None,
                   help="override the config's learning rate")
    p.add_argument("--lr_schedule", default=None,
                   choices=("constant", "adaptive", "linear"))
    p.add_argument("--lr_decay_epochs", type=int, default=None,
                   help="linear lr schedule: epochs to reach lr_min_frac")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to load (overrides the config's warm start)")
    p.add_argument("--pi_low_checkpoint", default=None,
                   help="trained low-level imitation checkpoint to embed in "
                        "tennis configs (default: <out>/<player>_im/best.npz "
                        "when present; otherwise PD-only tracking)")
    p.add_argument("--motion_file", default=None,
                   help="MotionLib .npz for imitation configs (default: synthetic)")
    p.add_argument("--out", default="results",
                   help="output dir for checkpoints + metrics.jsonl")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks: joins torchrun's group, else starts D "
                        "ranks (one per card over NCCL; gloo ranks with --device cpu)")
    p.add_argument("--save_every", type=int, default=50)
    p.add_argument("--render", default=None, metavar="OUT.html",
                   help="with --test: export a rollout and write a "
                        "standalone HTML viewer")
    p.add_argument("--select_best", action="store_true",
                   help="with --render: rank envs by behavioral stats and "
                        "record the best")
    p.add_argument("--mvae_batches", type=int, default=None,
                   help="mvae configs: batches per epoch (default "
                        "nseqs/batch_size)")
    p.add_argument("--dataset_dir", default=None,
                   help="mvae configs: train on a video-format dataset "
                        "(manifest.json + npy) instead of the synthetic "
                        "fixture; generate one with "
                        "`python -m vid2player3d_torch.data.tennis_motion`")
    p.add_argument("--pre_run", action="store_true",
                   help="mvae configs: 5-epoch smoke train + random-walk "
                        "rollout metrics")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of training epochs "
                        "2-4 into DIR/trace.json")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card; 'cpu' runs on "
                        "the CPU)")
    return p


class MetricsLogger:
    """One JSON line per epoch; a console summary with fps and ETA."""

    def __init__(self, out_dir: str, max_epochs: int):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.t0 = time.time()
        self.max_epochs = max_epochs
        self._ema_dt = None     # per-epoch pace, first epoch excluded
        self._last_wall = 0.0

    def log(self, epoch: int, metrics: dict, env_steps: int) -> None:
        row = {"epoch": epoch,
               **{k: float(v) for k, v in metrics.items()},
               "wall_s": round(time.time() - self.t0, 2)}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        # fps/ETA from recent per-epoch deltas (EMA), not the cumulative
        # mean: the first epoch carries the kernel builds and warm-up
        dt_step = row["wall_s"] - self._last_wall
        self._last_wall = row["wall_s"]
        if epoch > 1:
            self._ema_dt = dt_step if self._ema_dt is None \
                else 0.9 * self._ema_dt + 0.1 * dt_step
        dt = self._ema_dt if self._ema_dt is not None else dt_step
        fps = env_steps / max(dt, 1e-6)
        eta = dt * (self.max_epochs - epoch)
        print(f"epoch {epoch}/{self.max_epochs} "
              f"reward {row.get('reward_mean', float('nan')):.4f} "
              f"fps {fps:,.0f} eta {eta / 60:.1f}m", flush=True)

    def close(self) -> None:
        self._f.close()


def _clamp_minibatch(cfg, num_envs):
    """Scaled-down runs (--num_envs below the config's production scale)
    keep working: the minibatch can never exceed the rollout batch and must
    divide it."""
    nbatch = num_envs * cfg.horizon
    mb = min(cfg.minibatch_size, nbatch)
    while nbatch % mb:
        mb -= 1
    if mb != cfg.minibatch_size:
        cfg = dataclasses.replace(cfg, minibatch_size=mb)
    return cfg


def _learner_overrides(cfg, args):
    for f, dst in (("horizon", "horizon"), ("minibatch_size", "minibatch_size"),
                   ("lr", "learning_rate"), ("lr_schedule", "lr_schedule"),
                   ("lr_decay_epochs", "lr_decay_epochs")):
        if getattr(args, f):
            cfg = dataclasses.replace(cfg, **{dst: getattr(args, f)})
    return cfg


def _build_im(run_cfg, args, device, mesh=None):
    from vid2player3d_torch.data.motion_lib import MotionLib
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO

    env_cfg = run_cfg.env_im
    if args.num_envs:
        env_cfg = dataclasses.replace(env_cfg, num_envs=args.num_envs)
    ppo_cfg = _clamp_minibatch(_learner_overrides(run_cfg.ppo, args), env_cfg.num_envs)
    if args.motion_file:
        lib = MotionLib.load(args.motion_file, device=device)
    else:
        print("NOTE: no --motion_file; using synthetic motions (no AMASS data "
              "ships with the repository)")
        lib = make_synthetic_motion_lib(num_motions=8, T=120, fps=30.0, seed=run_cfg.seed,
                                        device=device)
    seed = args.seed or run_cfg.seed
    env = HumanoidImEnv(env_cfg, lib, rng=seed, device=device)
    if mesh is not None:
        env = env.shard(mesh)
    return ImitationPPO(env, ppo_cfg, seed=seed, mesh=mesh, device=device)


def _build_tennis(run_cfg, args, device, mesh=None):
    import numpy as np

    from vid2player3d_torch.envs import DualTennisEnv, TennisEnv
    from vid2player3d_torch.learn import V2PPPO
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    env_cfg = run_cfg.env_tennis
    if args.num_envs:
        env_cfg = dataclasses.replace(env_cfg, num_envs=args.num_envs)
    v2p_cfg = _clamp_minibatch(_learner_overrides(run_cfg.v2p, args), env_cfg.num_envs)
    seed = args.seed or run_cfg.seed

    # the incoming-ball pool honors the config's bounce box (stage-1a
    # narrows ball_bounce_x_half for the strike-first curriculum)
    bx = env_cfg.ball_bounce_x_half
    gen_cfg = None if bx >= 3.0 else {
        "bounce_min": [-bx, -10.0, 0.0], "bounce_max": [bx, -7.0, 0.0]}

    def load_player(name, fallback_key):
        sp, ft = _load_mvae_spec(os.path.join(args.out, f"mvae_{name}"), name,
                                 seed + fallback_key, device)
        if args.test:
            # evaluation runs the eval-mode spec: policy residuals gated to
            # the forehand/backhand swing phases
            sp = dataclasses.replace(sp, is_train=False)
        if ft is None:
            # no trained MVAE: synthetic init-condition frames
            rng = np.random.default_rng(seed + fallback_key)
            ft = (rng.standard_normal((64, P.FRAME_SIZE)) * 0.05).astype(np.float32)
            ft[:, 2] = 0.95
        return sp, ft

    spec, feats = load_player(run_cfg.player, 0)
    # the frozen low-level policy tracks the MVAE's kinematic targets
    pi_low = _load_pi_low(run_cfg, args, device)
    pool = TennisBallGenerator(gen_cfg, device=device)
    if run_cfg.dual:
        # two player identities: per-lane MVAE spec, init frames, frozen
        # pi_low, handedness and two-hand flag; one policy per identity,
        # routed by lane
        player_b = run_cfg.player_b or run_cfg.player
        spec_b, feats_b = load_player(player_b, 1)
        pi_low_b = _load_pi_low(dataclasses.replace(run_cfg, player=player_b), args, device)
        two_handed = ("djokovic", "nadal")
        env = DualTennisEnv(env_cfg, (spec, spec_b), (feats, feats_b), ball_generator=pool,
                            pi_low=pi_low, pi_low_b=pi_low_b,
                            two_hand_lanes=(run_cfg.player in two_handed,
                                            player_b in two_handed), device=device)
        v2p_cfg = dataclasses.replace(v2p_cfg, num_policies=2)
    else:
        env = TennisEnv(env_cfg, spec, feats, ball_generator=pool, pi_low=pi_low,
                        device=device)
    if mesh is not None:
        env = env.shard(mesh)
    return V2PPPO(env, v2p_cfg, seed=seed, mesh=mesh, device=device)


def _load_pi_low(run_cfg, args, device):
    """The embedded low-level imitation policy: `--pi_low_checkpoint` when
    given, else the player's `<player>_im` training output under `--out`
    (then `djokovic_im`, then `amass_im`; `best.npz` before `latest.npz`),
    else an all-zero policy (PD-only tracking of the MVAE targets)."""
    from vid2player3d_torch.learn import FrozenImitator

    path = args.pi_low_checkpoint
    if path is None:
        for name in (f"{run_cfg.player}_im", "djokovic_im", "amass_im"):
            for f in ("best.npz", "latest.npz"):
                cand = os.path.join(args.out, name, f)
                if os.path.exists(cand):
                    path = cand
                    break
            if path:
                break
    if path is None:
        print("NOTE: no low-level imitation checkpoint found; tennis physics "
              "falls back to PD-only tracking of the MVAE targets")
        return FrozenImitator.zeros(device=device).as_pi_low()
    print(f"embedding frozen low-level policy from {path}")
    return FrozenImitator.from_checkpoint(path, device=device).as_pi_low()


def _load_mvae_spec(mvae_dir: str, player: str, seed: int, device):
    """A trained MVAE checkpoint when `mvae_dir/latest.npz` exists, else a
    random spec. Returns (spec, init-condition frames or None); a trained
    MVAE's init conditions are the raw dataset frames saved beside it
    (`init_frames.npy`) when present. Nadal plays left-handed."""
    import numpy as np

    from vid2player3d_torch.tennis import player as P

    meta = os.path.join(mvae_dir, "latest.npz")
    if os.path.exists(meta):
        from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset

        opt = MVAEOption.load(player)
        opt.checkpoint_dir = os.path.dirname(mvae_dir) or "."
        opt.model_ver = os.path.basename(mvae_dir)
        ds = make_synthetic_pose_dataset(opt)
        tr = MVAETrainer(opt, ds, device=device)
        tr.load_checkpoint("latest")
        init_path = os.path.join(mvae_dir, "init_frames.npy")
        init = np.load(init_path) if os.path.exists(init_path) else ds.raw_init_frames(64)
        return P.spec_from_trainer(tr, player=player, righthand=(player != "nadal")), init
    print(f"NOTE: no trained MVAE at {meta}; using a random spec")
    spec = P.make_random_spec(seed, player=player, device=device)
    if player == "nadal":
        spec = dataclasses.replace(spec, righthand=False)
    return spec, None


def _train_loop(agent, run_cfg, args, logger, ts0=None):
    import torch

    best = float("-inf")
    ts = ts0 if ts0 is not None else agent.init_state()
    env_steps = agent.num_envs_global * agent.cfg.horizon
    epochs = args.epochs or run_cfg.max_epochs
    prof = None
    try:
        for e in range(1, epochs + 1):
            # trace epochs 2-4, after the first epoch's warm-up
            if args.profile and e == 2 and agent.rank == 0:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if agent.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            ts, metrics = agent.train_epoch(ts)
            if prof is not None and e == 4:
                if agent.device.type == "cuda":
                    torch.cuda.synchronize(agent.device)
                prof.__exit__(None, None, None)
                os.makedirs(args.profile, exist_ok=True)
                path = os.path.join(args.profile, "trace.json")
                prof.export_chrome_trace(path)
                prof = None
                print(f"profiler trace written to {path}")
            if logger is not None:
                logger.log(e, metrics, env_steps)
            # the metrics are global: every rank takes the same branches
            r = float(metrics.get("reward_mean", 0.0))
            if e % args.save_every == 0 or e == epochs:
                agent.save_checkpoint(os.path.join(args.out, "latest.npz"), ts)
            if r > best:
                best = r
                agent.save_checkpoint(os.path.join(args.out, "best.npz"), ts)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if logger is not None:
            logger.close()
    return ts


def _eval_loop(agent, run_cfg, args, ts=None):
    """Deterministic evaluation: the reward and behavioral report; with
    --render also an exported rollout and its standalone HTML viewer."""
    from vid2player3d_torch.eval import evaluate

    report = evaluate(agent, num_epochs=args.epochs or 5, ts=ts)
    print(json.dumps(report, indent=2))

    if args.render:
        import numpy as np

        from vid2player3d_torch.eval import (eval_tennis, export_imitation_rollout,
                                             export_rollout, select_best)
        from vid2player3d_torch.learn import V2PPPO
        from vid2player3d_torch.vis import render_html

        npz = os.path.splitext(args.render)[0] + ".npz"
        if isinstance(agent, V2PPPO):
            export_rollout(agent, npz, ts=ts)
            env_ids = None
            if args.select_best:
                _, stats_pe = eval_tennis(agent, per_env=True, ts=ts)
                env_ids = select_best(stats_pe, num=4)
                print(f"select_best env ids: {np.asarray(env_ids).tolist()}")
            render_html(npz, args.render, env_ids=env_ids, dual=run_cfg.dual)
        else:
            # imitation: the simulated skeleton beside the reference ghost
            export_imitation_rollout(agent, npz, ts=ts)
            render_html(npz, args.render)
        print(f"wrote {args.render}")
    return report


def _run_mvae(run_cfg, args, device) -> int:
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset
    from vid2player3d_torch.mvae.eval import report_for_trainer

    opt = MVAEOption.load(run_cfg.mvae_version)
    if args.seed is not None:
        opt.seed = args.seed
    if args.pre_run:
        # smoke scale: 5 epochs over 1000 seqs
        opt.nseqs = min(opt.nseqs, 1000)
    # checkpoints land at <out>/mvae_<player>/latest.npz, where the tennis
    # configs look for them
    opt.checkpoint_dir = args.out
    opt.model_ver = f"mvae_{run_cfg.player}"
    if args.dataset_dir:
        from vid2player3d_torch.mvae.dataset import load_video_dataset

        ds = load_video_dataset(opt, args.dataset_dir)
        print(f"dataset: {args.dataset_dir} ({len(ds.rollouts)} rollout windows)")
    else:
        ds = make_synthetic_pose_dataset(opt)
    trainer = MVAETrainer(opt, ds, device=device)
    if args.test:
        # random-walk rollout harness of a trained MVAE
        trainer.load_checkpoint("latest")
        print(json.dumps(report_for_trainer(trainer), indent=2))
        return 0
    epochs = args.epochs or (opt.n_epochs + opt.n_epochs_decay)
    if args.pre_run and not args.epochs:
        # 5-epoch smoke + rollout metrics; an explicit --epochs wins
        epochs = 5
    logger = MetricsLogger(args.out, epochs)
    try:
        for e in range(1, epochs + 1):
            m = trainer.train_epoch(batches_per_epoch=args.mvae_batches)
            logger.log(e, m, 0)
            if e % args.save_every == 0 or e == epochs:
                trainer.save_checkpoint("latest")
    finally:
        logger.close()
    print(json.dumps(report_for_trainer(trainer, num_steps=120), indent=2))
    return 0


def _start_ranks(args, argv) -> int:
    """`--n_devices D` outside torchrun: D ranks, one per visible card over
    NCCL (in this process at D = 1), or D gloo ranks with `--device cpu`."""
    from vid2player3d_torch import parallel
    from vid2player3d_torch.parallel import mesh as PM

    D = args.n_devices
    cpu = args.device is not None and args.device.startswith("cpu")
    if not cpu:
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass --device cpu to run the "
                               "ranks on the CPU")
        if D > cards:
            raise RuntimeError(f"--n_devices {D} needs {D} cards (one NCCL rank each); "
                               f"{cards} visible")
    if D == 1:
        import tempfile

        import torch.distributed as dist

        with tempfile.TemporaryDirectory(prefix="v2p_dp_") as tmp:
            dev = parallel.init_process_group(0, 1, "file://" + os.path.join(tmp, "rendezvous"),
                                              device="cpu" if cpu else None,
                                              timeout_s=PM.DEFAULT_TIMEOUT_S)
            try:
                return _rank_main(parallel.data_parallel_mesh(1, device=dev), argv)
            finally:
                dist.destroy_process_group()
    return max(parallel.spawn(_rank_main, D, args=(argv,), device="cpu" if cpu else None,
                              timeout_s=PM.DEFAULT_TIMEOUT_S))


def _rank_main(mesh, argv) -> int:
    """One rank of a data-parallel run: ranks above 0 print nothing."""
    quiet = open(os.devnull, "w") if mesh.rank else None
    try:
        with contextlib.redirect_stdout(quiet) if quiet else contextlib.nullcontext():
            print(f"data parallel: {mesh.dp} rank(s) over {mesh.backend}, rank 0 on "
                  f"{mesh.device}", flush=True)
            return _run(build_parser().parse_args(argv), mesh)
    finally:
        if quiet:
            quiet.close()


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.n_devices is not None and args.n_devices < 1:
        raise ValueError(f"--n_devices {args.n_devices}")
    if args.n_devices is None or args.test:
        if args.test and args.n_devices is not None:
            print("NOTE: --test evaluates in one process (rank 0)")
        return _run(args)
    from vid2player3d_torch.cli.configs import get_config

    if get_config(args.cfg).kind == "mvae":
        # the JAX CLI builds no mesh for the MotionVAE either
        print("NOTE: the MotionVAE trains in one process; --n_devices applies to the PPO "
              "learners")
        return _run(args)
    from vid2player3d_torch import parallel

    if parallel.initialize_distributed(device="cpu" if args.device == "cpu" else None,
                                       timeout_s=parallel.mesh.DEFAULT_TIMEOUT_S):
        try:
            return _rank_main(parallel.data_parallel_mesh(args.n_devices), argv)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    return _start_ranks(args, argv)


def _run(args, mesh=None) -> int:
    """Build, load and train or evaluate; under a mesh this process is one
    rank."""
    from vid2player3d_torch.cli.configs import get_config
    from vid2player3d_torch.utils.runtime import resolve_device

    run_cfg = get_config(args.cfg)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if run_cfg.kind == "mvae":
        return _run_mvae(run_cfg, args, device)

    agent = _build_im(run_cfg, args, device, mesh) if run_cfg.kind == "im" \
        else _build_tennis(run_cfg, args, device, mesh)

    ck = args.checkpoint
    if ck is None and run_cfg.warm_start:
        cand = os.path.join(args.out, run_cfg.warm_start, "best.npz")
        ck = cand if os.path.exists(cand) else None
    ts0 = None
    if ck:
        if run_cfg.kind == "im":
            ts0 = agent.load_checkpoint(ck)
        else:
            ts0 = agent.load_stage_checkpoint(
                ck, discard_sigma=run_cfg.discard_pretrained_sigma)

    if args.test:
        _eval_loop(agent, run_cfg, args, ts=ts0)
        return 0

    logger = MetricsLogger(args.out, args.epochs or run_cfg.max_epochs) \
        if mesh is None or mesh.rank == 0 else None
    _train_loop(agent, run_cfg, args, logger, ts0=ts0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
