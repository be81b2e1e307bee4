"""Data-level go/no-go for the synthetic swing rig: would a perfectly timed
strike with the generated swings return the ball into the opponent's court?

For each annotated contact of freshly generated rally sequences this takes
the racket head's kinematic velocity and face normal at the hit frame,
applies the environment's racket-contact math (restitution reflection and
spin gain, `envs/tennis.py` `_ball_physics`, with `TennisConfig`'s
constants) to a sampled incoming ball, and flies the returned ball with the
aerodynamic model (`tennis/ball.py` `simulate_flight`) on the requested
device. Reports the net-clear and bounce-in rates.

    python -m vid2player3d_torch.scripts.swing_quality [--swing_speed 1.0] [--n 8]
        [--seed 3] [--device DEV]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from vid2player3d_torch.data.tennis_motion import (R_WRIST, Skeleton, generate_rally_sequence,
                                                   grip_arrays)
from vid2player3d_torch.envs.tennis import TennisConfig

COURT_HALF_LEN = 11.885
COURT_HALF_W = 4.115
NET_H = 0.914
# the environment's own stringbed contact constants: the probe means
# something only if it applies `_ball_physics`'s math as it is
_CFG = TennisConfig()
RACKET_RESTITUTION = _CFG.racket_restitution
SPIN_GAIN = _CFG.spin_gain
SPIN_CAP = _CFG.spin_cap


def collect_contacts(n_seq: int, swing_speed: float, seed: int):
    """(racket head position, velocity, face normal) at every annotated
    contact of `n_seq` generated rally sequences, float64 numpy."""
    skel = Skeleton.from_smpl()
    reach = grip_arrays("eastern")[2]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_seq):
        seq = generate_rally_sequence(rng, skel, swing_speed=swing_speed)
        rot = seq["joint_rotmat"].astype(np.float64)
        root = seq["joint_pos"][:, 0].astype(np.float64)
        pw, Rw = skel.fk(rot, root)
        head = pw[:, R_WRIST] - Rw[:, R_WRIST, :, 0] * reach
        normal = Rw[:, R_WRIST, :, 1]                 # grip normal = +y column
        vel = np.zeros_like(head)
        vel[1:-1] = (head[2:] - head[:-2]) * 15.0
        for f, fg in seq["hits"]:
            if fg and 0 < f < len(vel) - 1:
                out.append((head[f], vel[f], normal[f]))
    return out


def swing_quality(n: int = 8, swing_speed: float = 1.0, seed: int = 3, device=None) -> dict:
    """The probe's numbers: contacts, the racket head's mean speed, the
    returned ball's mean speed and median vertical velocity, the share that
    clears the net, the share that also bounces in, and the median bounce y
    of those that clear (nan when none does)."""
    import torch

    from vid2player3d_torch.tennis import ball as B
    from vid2player3d_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    contacts = collect_contacts(n, swing_speed, seed)
    rng = np.random.default_rng(seed + 1)
    pos0, vel0, spin0, speeds = [], [], [], []
    for cpos, rvel, nrm in contacts:
        # the incoming ball at the contact point: a descending post-bounce
        # flight toward the player (the pool's ranges)
        bvel = np.array([rng.uniform(-2.0, 2.0),
                         -rng.uniform(8.0, 14.0),
                         rng.uniform(-7.0, -1.0)])
        rel = bvel - rvel
        vn = float(rel @ nrm)
        if vn >= 0:          # the face points away from the incoming ball
            refl = rel
        else:
            refl = rel - (1.0 + RACKET_RESTITUTION) * vn * nrm
        out_v = rvel + refl
        tang = refl - (refl @ nrm) * nrm
        pos0.append(cpos)
        vel0.append(out_v)
        spin0.append(min(SPIN_GAIN * np.linalg.norm(tang), SPIN_CAP))
        speeds.append(np.linalg.norm(rvel))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    traj = B.simulate_flight(f32(np.stack(pos0)), f32(np.stack(vel0)), f32(spin0),
                             num_frames=120)
    bp = traj.bounce_pos.cpu().numpy()
    bounced = traj.has_bounce.cpu().numpy()
    net_clear = traj.pass_net.cpu().numpy()
    land_in = (bounced & (np.abs(bp[:, 0]) < COURT_HALF_W)
               & (bp[:, 1] > 0) & (bp[:, 1] < COURT_HALF_LEN))
    ret_in = net_clear & land_in
    v = np.stack(vel0).astype(np.float32)     # the flight's own (float32) launch velocities
    return {"contacts": len(speeds),
            "head_speed_mean": float(np.mean(speeds)),
            "out_speed_mean": float(np.linalg.norm(v, axis=1).mean()),
            "out_vz_p50": float(np.median(v[:, 2])),
            "net_clear": float(net_clear.mean()),
            "bounce_in": float(ret_in.mean()),
            "bounce_y_p50": float(np.median(bp[net_clear][:, 1])) if net_clear.any()
            else float("nan")}


def format_report(q: dict) -> str:
    """The JAX script's two lines."""
    return (f"contacts={q['contacts']}  head_speed mean={q['head_speed_mean']:.1f} "
            f"m/s  out_speed mean={q['out_speed_mean']:.1f} m/s "
            f"out_vz p50={q['out_vz_p50']:.1f}\n"
            f"net_clear={q['net_clear']:.2f}  bounce_in={q['bounce_in']:.2f} "
            f" (bounce_y p50={q['bounce_y_p50']:.1f})")


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--swing_speed", type=float, default=1.0)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    a = ap.parse_args(argv)
    q = swing_quality(a.n, a.swing_speed, a.seed, a.device)
    print(format_report(q))
    return q


if __name__ == "__main__":
    main()
