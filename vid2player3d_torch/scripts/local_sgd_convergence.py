"""Local SGD's convergence against synchronous data parallelism.

`dp_sync="per_mini_epoch"` (local SGD: each rank steps Adam on its own
minibatches; params and both moments are averaged once per mini-epoch)
changes the optimization of the reference, which steps Adam on every
minibatch with the ranks' summed gradients (`dp_sync="per_minibatch"`). This
script trains the amass_im imitation task on the hard sinusoidal AMASS
fixture (through the AMASS converter: a workload with learning headroom)
over 4 data-parallel ranks under both modes, with the same seeds and
hyperparameters, and writes

    OUT/per_minibatch.jsonl
    OUT/per_mini_epoch.jsonl
    OUT/report.json   (first/last/best rewards and the verdict)

into OUT (default artifacts/torch_local_sgd). The ranks are processes
(`parallel.spawn`): on the card all 4 share it over gloo; with
`--device cpu` they are gloo ranks on the CPU.

    python -m vid2player3d_torch.scripts.local_sgd_convergence [EPOCHS] [NUM_ENVS]
        [--device DEV]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np

DEFAULT_OUT = os.path.join("artifacts", "torch_local_sgd")
RANKS = 4
MODES = ("per_minibatch", "per_mini_epoch")
CONFIG = ("hard fixture, amass_im semantics (horizon 16, mb 64/chip, 6 mini-epochs, "
          "lr 1e-4 constant)")
MATCH_MARGIN = 0.02


def _hard_fixture_lib(d: str) -> str:
    """The hard sinusoidal AMASS fixture (amplitudes 0.3-0.8 rad) written to
    `d` and converted on the host; the path of its saved MotionLib. The
    default synthetic library starts at PD parity, where a comparison of
    the modes would say nothing."""
    from vid2player3d_torch.scripts.probe_e2e_im import fixture_lib

    path = os.path.join(d, "lib.npz")
    fixture_lib(d, path, 0.3, 0.8, "cpu")
    return path


def run_mode(mesh, dp_sync: str, epochs: int, num_envs: int, out_path: str,
             lib_path: str) -> list:
    """One rank of one mode's run (`parallel.spawn` imports it by name):
    `epochs` epochs of `num_envs` envs over the mesh; rank 0 writes the rows
    to `out_path` and prints its progress. Returns the rows."""
    from vid2player3d_torch.data.motion_lib import MotionLib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    lib = MotionLib.load(lib_path, device=mesh.device)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=num_envs, substeps=2), lib, rng=0,
                        device=mesh.device).shard(mesh)
    # amass_im's update scaled to the fixture: several sequential minibatch
    # Adam steps per mini-epoch on each rank, so that the two modes'
    # optimizer trajectories differ
    agent = ImitationPPO(
        env, PPOConfig(horizon=16, minibatch_size=64, mini_epochs=6,
                       minibatch_per_chip=True, dp_sync=dp_sync,
                       learning_rate=1e-4, lr_schedule="constant"),
        seed=7, mesh=mesh)
    ts = agent.init_state()
    rows = []
    t0 = time.time()
    f = open(out_path, "w") if mesh.rank == 0 else None
    try:
        for e in range(1, epochs + 1):
            ts, m = agent.train_epoch(ts)
            row = {"epoch": e, **{k: float(v) for k, v in m.items()},
                   "wall_s": round(time.time() - t0, 2)}
            rows.append(row)
            if f is not None:
                f.write(json.dumps(row) + "\n")
                f.flush()
                if e % 20 == 0 or e == 1:
                    print(f"[{dp_sync}] epoch {e}/{epochs} "
                          f"reward {row['reward_mean']:.4f}", flush=True)
    finally:
        if f is not None:
            f.close()
    return rows


def summarize(rows: list) -> dict:
    r = [x["reward_mean"] for x in rows]
    return {"reward_first10_mean": round(float(np.mean(r[:10])), 4),
            "reward_last20_mean": round(float(np.mean(r[-20:])), 4),
            "reward_best": round(float(np.max(r)), 4),
            "alive_last": round(rows[-1].get("alive_ratio", float("nan")), 4)}


def verdict(sync_last20: float, local_last20: float) -> str:
    """Local SGD matches when its last-20 mean reward is at least the
    synchronous one's less `MATCH_MARGIN`."""
    if local_last20 >= sync_last20 - MATCH_MARGIN:
        return "local SGD matches synchronous training on this workload"
    return ("local SGD converges WORSE than synchronous on this workload — "
            "prefer per_minibatch when accuracy matters; the 0.98 roofline "
            "number carries this caveat")


def main(epochs: int = 150, num_envs: int = 64, out: str = DEFAULT_OUT, device=None) -> dict:
    """Both modes in turn, then the report; returns it."""
    from vid2player3d_torch import parallel
    from vid2player3d_torch.scripts import local_sgd_convergence as this
    from vid2player3d_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    report = {"epochs": epochs, "num_envs": num_envs, "dp": RANKS, "config": CONFIG}
    with tempfile.TemporaryDirectory(prefix="local_sgd_fixture_") as d:
        lib_path = _hard_fixture_lib(d)
        for mode in MODES:
            # the ranks share one card over gloo (NCCL needs a card per
            # rank); the rank function by its module's name, which the ranks
            # import, also when this file runs as __main__
            results = parallel.spawn(
                this.run_mode, RANKS, args=(mode, epochs, num_envs,
                                       os.path.join(out, f"{mode}.jsonl"), lib_path),
                device=str(dev), backend="gloo")
            report[mode] = summarize(results[0])
    a = report["per_minibatch"]["reward_last20_mean"]
    b = report["per_mini_epoch"]["reward_last20_mean"]
    report["final_reward_ratio_local_over_sync"] = round(b / max(a, 1e-9), 4)
    report["verdict"] = verdict(a, b)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return report


def _cli(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("epochs", nargs="?", type=int, default=150)
    ap.add_argument("num_envs", nargs="?", type=int, default=64)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the ranks on the CPU")
    a = ap.parse_args(argv)
    main(a.epochs, a.num_envs, a.out, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
