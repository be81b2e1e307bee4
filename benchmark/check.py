"""The comparison that decides `correct`, and the printing of each number
beside its limit.

A training cell compares the port's first checked epochs with the
reference's on the same inputs, weights and draws. Per checked epoch `e<k>`:

- `loss_gap`: the relative gap of the epoch's loss (the mean over its
  optimizer steps);
- `grad_gap`: the worst leaf's gap of gradient norms after the epoch (the
  root of Adam's summed second moment), over the larger of the reference's
  norm of that leaf and of the median leaf;
- `step_gap`: the worst leaf's gap of the norms of the params' change since
  the start, over the larger of the reference's change of that leaf and of
  the median leaf; `step_gap_median`: the median leaf's gap; leaves whose
  reference gradient is under a thousandth of the median leaf's are left
  out of both (they move by round-off);
- `reward_gap`: the relative gap of the rollout's mean reward.

A cell's limits file (`limits/<cell>.json`) names the numbers it compares,
each with its limit and the readings the limit was set from.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-30)


def train_numbers(prog: dict, ref: dict, params0: dict) -> Dict[str, float]:
    """Every number a training cell can compare, per checked epoch `e<k>`
    (see the module docstring); the cell's limits file says which it
    compares. `worst.<number>` names the leaf that gave it."""
    out: Dict[str, float] = {}
    worst: Dict[str, str] = {}
    for e, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        out[f"loss_gap.e{e}"] = _rel(lp, lr, 0.0)
        g_ref = ref["grads"][e - 1]
        g_med = statistics.median(g_ref)
        gaps = {k: _rel(a, b, g_med) for k, a, b in zip(ref["names"], prog["grads"][e - 1], g_ref)}
        worst[f"grad_gap.e{e}"] = max(gaps, key=gaps.get)
        out[f"grad_gap.e{e}"] = gaps[worst[f"grad_gap.e{e}"]]
        moving = [k for k, g in zip(ref["names"], g_ref) if g >= 1e-3 * g_med]
        worst[f"left_out.e{e}"] = [k for k in ref["names"] if k not in moving]
        pr, pp = ref["params"][e - 1], prog["params"][e - 1]
        d_ref = {k: float((pr[k] - params0[k]).norm()) for k in moving}
        d_prog = {k: float((pp[k].to(params0[k].device) - params0[k]).norm()) for k in moving}
        d_med = statistics.median(d_ref.values())
        gaps = {k: _rel(d_prog[k], d_ref[k], d_med) for k in moving}
        worst[f"step_gap.e{e}"] = max(gaps, key=gaps.get)
        out[f"step_gap.e{e}"] = gaps[worst[f"step_gap.e{e}"]]
        out[f"step_gap_median.e{e}"] = statistics.median(gaps.values())
        out[f"reward_gap.e{e}"] = _rel(prog["rewards"][e - 1], ref["rewards"][e - 1], 0.0)
    out["worst"] = worst
    return out


def compared(numbers: Dict[str, float], lims: Dict[str, float]) -> Dict[str, float]:
    """The numbers the cell's limits name."""
    return {k: numbers[k] for k in lims}


def judge(numbers: Dict[str, float], lims: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lims[k] for k, v in numbers.items())


def report(numbers: Dict[str, float], lims: Dict[str, float]) -> List[List]:
    """[[name, number, limit], ...] for the result line and standard error."""
    return [[k, numbers[k], lims[k]] for k in numbers]
