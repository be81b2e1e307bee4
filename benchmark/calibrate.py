"""The readings a training cell's limits are set from, on the chip, in one
process (set-up is long, so many seeds share it):

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]

For each of `--seeds` the port's checked epochs against the reference (the
lower readings); for each of `--control-seeds` also the control (the
reference in fp8, put in the port's place) and the half-batch fault (the
reference leaving half of each minibatch out) against the reference (the
upper readings). One JSON line per reading on standard output and in
`--out` when given.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import tempfile
import time

import torch

from . import check, spec
from .entries.train import checked_epochs
from .reference import train as ref_train


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = importlib.import_module(f"benchmark.kinds.{cfg['kind']}")
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(**row):
        line = json.dumps({"cell": cell["name"], **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    n = traffic["checked_epochs"]
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        with tempfile.TemporaryDirectory(prefix="bench_cal_") as work:
            inputs = kind.make_inputs(cfg, seed, work)
            t = time.perf_counter()
            agent, ts, prog, params0 = checked_epochs(kind, cfg, traffic, inputs, device)
            prog_s = time.perf_counter() - t
            del agent, ts
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = ref_train.run_epochs(kind, cfg, inputs, params0, n, device)
            ref_s = time.perf_counter() - t
            if seed in args.seeds:
                emit(seed=seed, side="port", numbers=check.train_numbers(prog, ref, params0),
                     losses=prog["losses"], ref_losses=ref["losses"], port_s=prog_s, ref_s=ref_s)
            if seed in args.control_seeds:
                for side, kw in (("control", {"control": True}),
                                 ("half_batch", {"fault": ref_train.half_batch})):
                    got = ref_train.run_epochs(kind, cfg, inputs, params0, n, device, **kw)
                    emit(seed=seed, side=side, numbers=check.train_numbers(got, ref, params0),
                         losses=got["losses"], ref_losses=ref["losses"])
            del ref, prog
            gc.collect()
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
