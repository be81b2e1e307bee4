"""Offline trajectory-pool generation CLI.

    python -m vid2player3d_torch.tennis.pool --out pool.npz \\
        [--num_candidates 100000] [--seed S] [--traj_length T] \\
        [--backend {auto,native,torch}] [--device DEV]

Draws the candidate launches, flies them (`native`: the C++/OpenMP integrator
on the host; `torch` and `auto`: `simulate_flight` on the device), keeps the
valid serves-in and writes them with `TennisBallGenerator.save_npz`, in the
layout that `TennisBallGenerator.from_npz` of either package reads. The
device is the card unless `--device` names another.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_candidates", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traj_length", type=int, default=100)
    ap.add_argument("--backend", default="auto", choices=("auto", "native", "torch"))
    ap.add_argument("--device", default=None,
                    help="device the pool lives on (default: the card)")
    args = ap.parse_args(argv)

    from .ball import TennisBallGenerator

    t0 = time.time()
    gen = TennisBallGenerator({"ball_traj_length": args.traj_length},
                              num_candidates=args.num_candidates, seed=args.seed,
                              backend=args.backend, device=args.device)
    gen.save_npz(args.out)
    print(f"pool: {gen.pool_size}/{args.num_candidates} valid trajectories "
          f"({gen.backend} backend, {time.time() - t0:.1f}s) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
