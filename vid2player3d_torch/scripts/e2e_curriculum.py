"""The full curriculum end to end through the port's command line.

On an AMASS-format fixture, five legs:

  1. AMASS-layout npz sequences -> `data.amass.convert_amass_dir` -> a
     MotionLib on disk
  2. `--cfg federer_im --motion_file <lib>`: low-level imitation training,
     then two deterministic evaluations (the initial policy, which is the
     pure-PD baseline, and the trained one)
  3. `--cfg mvae_federer --pre_run`: the MotionVAE's smoke training and its
     random-walk metrics
  4. `--cfg federer_train_stage_1`: high-level training with the frozen
     low-level policy of leg 2 embedded
  5. `--cfg federer_train_stage_1 --test --render`: evaluation and the HTML
     rollout

At the imitation leg's full depth (300 epochs or more) the run also checks
that it learns: the last ten epochs' mean reward above the first ten's, the
median kl below 1, and the trained policy tracking better (lower MPJPE) than
pure PD. Below that depth it checks only that every leg runs.

    python -m vid2player3d_torch.scripts.e2e_curriculum [OUT_DIR] [--device DEV]

Writes `e2e_report.json`, the legs' metrics and `rollout.html` into OUT_DIR
(default artifacts/torch_e2e).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time
from typing import Optional

import numpy as np

DEFAULT_OUT = os.path.join("artifacts", "torch_e2e")
FULL_IM_EPOCHS = 300      # the depth at which the learning checks apply


def write_amass_fixture(d, n_files=3, T=180, fps=60.0, seed=0):
    """AMASS npz layout (SMPLH): poses (T, 156), trans (T, 3), betas (16),
    gender, mocap_framerate; sinusoidal joint motion of amplitudes 0.3-0.8
    rad, hard enough that the PD-parity init is far from optimal (an easy
    fixture starts near the optimum, and PPO then only drifts;
    `probe_e2e_im` compares the two)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = np.linspace(0, T / fps, T)[:, None]
        freq = rng.uniform(0.5, 1.5, (1, 156))
        amp = rng.uniform(0.3, 0.8, (1, 156))
        poses = (amp * np.sin(2 * np.pi * freq * t + rng.uniform(
            0, 2 * np.pi, (1, 156)))).astype(np.float64)
        poses[:, :3] = 0.0
        trans = np.stack([0.3 * np.sin(t[:, 0]), 0.3 * t[:, 0],
                          np.zeros(T)], -1)
        np.savez(os.path.join(d, f"seq_{i}.npz"), poses=poses, trans=trans,
                 betas=rng.uniform(-0.5, 0.5, 16), gender="neutral",
                 mocap_framerate=np.float64(fps))


def last_json_object(text: str) -> dict:
    """The last top-level JSON object in `text`. The evaluation's report is
    the last thing the command line prints; anything before it (notes, a
    brace in a log line) is skipped."""
    end = text.rindex("}")
    depth = 0
    for i in range(end, -1, -1):
        depth += {"}": 1, "{": -1}.get(text[i], 0)
        if depth == 0:
            return json.loads(text[i:end + 1])
    raise ValueError("no complete JSON object in the command's output")


def imitation_summary(rows: list) -> dict:
    """The imitation leg's report from its metrics rows (kl from epoch 2 on)."""
    r = [row["reward_mean"] for row in rows]
    kl = [row.get("kl", float("nan")) for row in rows[1:]]
    return {"epochs": len(rows),
            "reward_first": round(r[0], 4),
            "reward_first10_mean": round(float(np.mean(r[:10])), 4),
            "reward_last10_mean": round(float(np.mean(r[-10:])), 4),
            "reward_last": round(r[-1], 4),
            "kl_median": round(float(np.nanmedian(kl)), 4) if kl else float("nan"),
            "alive_last": round(rows[-1]["alive_ratio"], 4)}


def check_imitation_learned(imitation: dict) -> None:
    """A run that does not learn fails loudly: the report is evidence of the
    pipeline only if the imitation leg learns."""
    if not imitation["reward_last10_mean"] > imitation["reward_first10_mean"]:
        raise AssertionError(f"imitation leg anti-learned: {imitation}")
    if not imitation["kl_median"] < 1.0:
        raise AssertionError(f"imitation KL exploded: {imitation}")


def check_tracks_better(report: dict) -> None:
    """The trained policy must track better than pure PD. At fixture scale
    the reference translates while the root is unactuated, so the bound is
    relative, not an absolute one the fixture cannot reach."""
    if not report["imitation_eval"]["mpjpe"] < report["imitation_eval_pd_baseline"]["mpjpe"]:
        raise AssertionError(f"trained policy tracks WORSE than pure PD: {report}")


def main(out: str = DEFAULT_OUT, device=None, im_epochs: int = FULL_IM_EPOCHS,
         im_envs: int = 64, im_horizon: int = 16, im_minibatch: int = 256,
         eval_envs: int = 64, eval_resets: int = 2, mvae_epochs: Optional[int] = None,
         mvae_batches: Optional[int] = None, stage1_epochs: int = 5, stage1_envs: int = 16,
         stage1_horizon: int = 8, stage1_minibatch: int = 32, render_envs: int = 8) -> dict:
    """The five legs; returns the report written to `out/e2e_report.json`.
    The defaults are the JAX script's sizes; smaller ones make a smoke run
    (the learning checks apply from `FULL_IM_EPOCHS` imitation epochs)."""
    from vid2player3d_torch.cli.run import main as cli
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.data.amass import convert_amass_dir
    from vid2player3d_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    report = {}

    def leg(name, argv):
        t0 = time.perf_counter()
        rc = cli(argv + ["--device", str(dev)])
        if rc != 0:
            raise RuntimeError(f"{name}: the command line exited {rc}")
        return time.perf_counter() - t0

    # 1. AMASS fixture -> MotionLib
    t0 = time.perf_counter()
    amass_dir = os.path.join(out, "amass_fixture")
    write_amass_fixture(amass_dir)
    lib = convert_amass_dir(amass_dir, smpl_model=S.make_synthetic_smpl(), target_fps=30.0,
                            device=dev)
    lib_path = os.path.join(out, "motion_lib.npz")
    lib.save(lib_path)
    report["motion_lib"] = {"num_motions": int(lib.num_motions),
                            "total_frames": int(lib.gts.shape[0])}
    print(f"[1/5] MotionLib: {report['motion_lib']} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # 2. low-level imitation on the converted data
    im_out = os.path.join(out, "federer_im")
    for stale in (os.path.join(im_out, "metrics.jsonl"), os.path.join(out, "metrics.jsonl")):
        if os.path.exists(stale):
            os.remove(stale)   # the logger appends; the report covers this run only
    # 64 envs, horizon 16, minibatch 256, lr 1e-4 constant: the smallest
    # scale at which this leg learns (`probe_e2e_im`; 16 envs at horizon 8
    # drift or anti-learn at any lr)
    secs = leg("federer_im", ["--cfg", "federer_im", "--motion_file", lib_path,
                              "--num_envs", str(im_envs), "--horizon", str(im_horizon),
                              "--minibatch_size", str(im_minibatch), "--lr", "1e-4",
                              "--lr_schedule", "constant", "--epochs", str(im_epochs),
                              "--seed", "1", "--out", im_out])
    with open(os.path.join(im_out, "metrics.jsonl")) as f:
        report["imitation"] = imitation_summary([json.loads(line) for line in f])
    learning_checked = im_epochs >= FULL_IM_EPOCHS
    if learning_checked:
        check_imitation_learned(report["imitation"])

    # deterministic full-episode evaluations, untrained (the small-init
    # residual heads start the policy at pure PD) and trained; the trained
    # one must name its checkpoint, or the command line evaluates the init
    def det_eval(ckpt):
        buf = io.StringIO()
        args = ["--cfg", "federer_im", "--motion_file", lib_path,
                "--num_envs", str(eval_envs), "--test", "--epochs", str(eval_resets),
                "--seed", "1", "--out", im_out]
        if ckpt:
            args += ["--checkpoint", ckpt]
        with contextlib.redirect_stdout(buf):
            leg("federer_im --test", args)
        ev = last_json_object(buf.getvalue())
        return {k: round(ev[k], 4) for k in
                ("reward_mean", "mpjpe", "episode_len", "success_rate") if k in ev}

    t1 = time.perf_counter()
    report["imitation_eval_pd_baseline"] = det_eval(None)
    report["imitation_eval"] = det_eval(os.path.join(im_out, "best.npz"))
    if learning_checked:
        check_tracks_better(report)
    print(f"[2/5] imitation: {report['imitation']} {report['imitation_eval']} "
          f"(train {secs:.1f} s, evals {time.perf_counter() - t1:.1f} s)", flush=True)

    # 3. the MotionVAE's pre-run (5 epochs unless given) and random-walk metrics
    argv = ["--cfg", "mvae_federer", "--pre_run", "--seed", "1", "--out", out]
    if mvae_epochs is not None:
        argv += ["--epochs", str(mvae_epochs)]
    if mvae_batches is not None:
        argv += ["--mvae_batches", str(mvae_batches)]
    secs = leg("mvae_federer --pre_run", argv)
    # it shares --out with leg 4: its metrics move aside so that stage 1's
    # metrics.jsonl starts clean
    os.replace(os.path.join(out, "metrics.jsonl"), os.path.join(out, "mvae_metrics.jsonl"))
    report["mvae"] = "pre_run ok (see stdout metrics + mvae_metrics.jsonl)"
    print(f"[3/5] mvae pre_run done ({secs:.1f} s)", flush=True)

    # 4. high-level stage 1 with the frozen low-level policy embedded
    pi_low = os.path.join(im_out, "best.npz")
    secs = leg("federer_train_stage_1",
               ["--cfg", "federer_train_stage_1", "--num_envs", str(stage1_envs),
                "--horizon", str(stage1_horizon), "--minibatch_size", str(stage1_minibatch),
                "--epochs", str(stage1_epochs), "--seed", "1",
                "--pi_low_checkpoint", pi_low, "--out", out])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    report["tennis_stage1"] = {"epochs": len(rows),
                               "reward_last": round(rows[-1]["reward_mean"], 5)}
    print(f"[4/5] tennis stage 1: {report['tennis_stage1']} ({secs:.1f} s)", flush=True)

    # 5. evaluation and the rendered rollout
    html = os.path.join(out, "rollout.html")
    secs = leg("federer_train_stage_1 --test --render",
               ["--cfg", "federer_train_stage_1", "--num_envs", str(render_envs), "--test",
                "--epochs", "1", "--seed", "1", "--pi_low_checkpoint", pi_low,
                "--checkpoint", os.path.join(out, "best.npz"), "--out", out,
                "--render", html])
    report["render"] = os.path.basename(html)
    with open(os.path.join(out, "e2e_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[5/5] wrote {os.path.join(out, 'e2e_report.json')} ({secs:.1f} s)", flush=True)
    return report


def _cli(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    a = ap.parse_args(argv)
    main(a.out, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
