"""Run one cell of `BENCHMARK.json` once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port. The last line of standard
output is the result, one JSON object; the numbers that decided `correct`
are also the last lines of standard error, each beside its limit. With no
CUDA device, or fewer than the cell asks for, it exits with code 2 and
prints no result; if JAX or the JAX package was loaded, with code 3.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


SETUP_START = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def _caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's own nvcc
    builds already go to `build/kernels/`)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from . import check, nojax, spec

    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    _caches(spec.ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell['chips']} CUDA device(s), found {n}: no result")
        return 2
    device = torch.device("cuda", 0)
    kind_name = torch.cuda.get_device_name(0)
    log(f"device {kind_name}; {torch.cuda.device_count()} visible, {cell['chips']} used; "
        f"nvidia-smi: {_power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.cuda.reset_peak_memory_stats(device)

    kind = importlib.import_module(f"benchmark.kinds.{cfg['kind']}")
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    per_layer = spec.per_layer(cell["name"]) if args.trace else []
    res = entry.run(cell, cfg, traffic, kind, args.seed, args.seconds, bool(args.trace), device,
                    SETUP_START, log, per_layer)

    bad = nojax.found()
    if bad:
        log(f"loaded what the benchmark may not run: {', '.join(bad)}: no result")
        return 3
    lims = check.limits(cell["name"])
    numbers = check.compared(res.numbers, lims)
    checks = check.report(numbers, lims)
    device_info = {"platform": "gpu", "kind": kind_name, "count": cell["chips"],
                   "memory_peak_bytes": int(res.memory_peak_bytes)}
    out = {"correct": check.judge(numbers, lims) and res.failed == 0,
           "attempted": res.attempted, "failed": res.failed, "metrics": res.metrics,
           "device": device_info}
    if args.trace:
        prof = res.profile
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
