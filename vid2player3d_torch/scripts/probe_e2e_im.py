"""Probe of the fixture and learning rate for the curriculum's imitation leg.

It looks for the settings at which that leg (``e2e_curriculum``) learns at
16 envs. An easy sinusoidal fixture starts the policy near the optimum
(the PD-parity init), so every PPO update is drift; this probe raises the
motion's difficulty and compares learning rates over a short run, three
runs of `federer_im` through the command line.

    python -m vid2player3d_torch.scripts.probe_e2e_im [--out DIR] [--epochs 80]
        [--device DEV]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

DEFAULT_OUT = os.path.join("artifacts", "torch_probe_e2e")
CASES = ((0.3, 0.8, "1e-4", "hard_1e-4"),
         (0.3, 0.8, "3e-5", "hard_3e-5"),
         (0.05, 0.25, "3e-5", "easy_3e-5"))


def write_fixture(d, amp_lo, amp_hi, n_files=3, T=180, fps=60.0, seed=0):
    """AMASS npz layout (SMPLH): poses (T, 156), trans (T, 3), betas (16),
    gender, mocap_framerate; sinusoidal joint motion of amplitudes drawn in
    [amp_lo, amp_hi) rad."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = np.linspace(0, T / fps, T)[:, None]
        freq = rng.uniform(0.5, 2.0, (1, 156))
        amp = rng.uniform(amp_lo, amp_hi, (1, 156))
        poses = (amp * np.sin(2 * np.pi * freq * t + rng.uniform(
            0, 2 * np.pi, (1, 156)))).astype(np.float64)
        poses[:, :3] = 0.0
        trans = np.stack([0.3 * np.sin(t[:, 0]), 0.5 * t[:, 0],
                          np.zeros(T)], -1)
        np.savez(os.path.join(d, f"seq_{i}.npz"), poses=poses, trans=trans,
                 betas=rng.uniform(-0.5, 0.5, 16), gender="neutral",
                 mocap_framerate=np.float64(fps))


def fixture_lib(d: str, lib_path: str, amp_lo: float, amp_hi: float, device):
    """The fixture written to `d`, converted through the AMASS converter with
    the synthetic SMPL model at 30 fps and saved to `lib_path`."""
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.data.amass import convert_amass_dir

    write_fixture(d, amp_lo, amp_hi)
    lib = convert_amass_dir(d, smpl_model=S.make_synthetic_smpl(), target_fps=30.0,
                            device=device)
    lib.save(lib_path)
    return lib


def main(out: str = DEFAULT_OUT, epochs: int = 80, device=None) -> list:
    """The three runs; one summary dict per run (also printed)."""
    from vid2player3d_torch.cli.run import main as cli
    from vid2player3d_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    summaries = []
    for amp_lo, amp_hi, lr, tag in CASES:
        lib_path = os.path.join(out, f"lib_{tag}.npz")
        fixture_lib(os.path.join(out, f"fix_{tag}"), lib_path, amp_lo, amp_hi, dev)
        run = os.path.join(out, f"run_{tag}")
        mf = os.path.join(run, "metrics.jsonl")
        if os.path.exists(mf):
            os.remove(mf)    # the logger appends: the summary covers this run only
        rc = cli(["--cfg", "federer_im", "--motion_file", lib_path,
                  "--num_envs", "16", "--horizon", "8",
                  "--minibatch_size", "32", "--lr", lr,
                  "--lr_schedule", "constant", "--epochs", str(epochs),
                  "--seed", "1", "--out", run, "--device", str(dev)])
        if rc != 0:
            raise RuntimeError(f"federer_im ({tag}) exited {rc}")
        with open(mf) as f:
            rows = [json.loads(line) for line in f]
        r = [x["reward_mean"] for x in rows]
        kl = [x.get("kl", float("nan")) for x in rows]
        s = {"tag": tag, "r0": r[0], "r10": float(np.mean(r[:10])),
             "r_last10": float(np.mean(r[-10:])), "r_end": r[-1], "kl0": kl[0],
             "kl_end": kl[-1], "alive": rows[-1]["alive_ratio"]}
        print(f"[{tag}] r0={s['r0']:.3f} r10={s['r10']:.3f} "
              f"r_last10={s['r_last10']:.3f} r_end={s['r_end']:.3f} "
              f"kl0={s['kl0']:.3f} kl_end={s['kl_end']:.3f} "
              f"alive={s['alive']:.3f}", flush=True)
        summaries.append(s)
    return summaries


def _cli(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    a = ap.parse_args(argv)
    main(a.out, a.epochs, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
