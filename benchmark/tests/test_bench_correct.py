"""`correct` at a size a test run holds, on the CPU: the harness driven
through a whole run past its look for a card, with the program sound and
broken underneath: a step that returns its state unchanged, and half of
each minibatch left out with the mean taken over the rest. The cell's
limits decide each; the readings that set them were taken on the chip at
the cell's own size. The control (the policy's trunks in fp8) is kept here
too: at this size its gaps stay under the limits (six optimizer steps an
epoch, not 3,072), so the test holds it to the sound run's gaps instead."""

import time

import pytest
import torch

from benchmark import check, spec
from benchmark.entries import train
from benchmark.reference import precision
from benchmark.reference import train as ref_train

CELLS = {"amass_im.train": 16}


def _unchanged(agent):
    step = agent.train_epoch

    def still(ts, *a, **kw):
        keep = [t.detach().clone() for t in list(ts.params.values()) + ts.opt_state.mu
                + ts.opt_state.nu]
        ts2, m = step(ts, *a, **kw)
        with torch.no_grad():
            for t, k in zip(list(ts2.params.values()) + ts2.opt_state.mu + ts2.opt_state.nu,
                            keep):
                t.copy_(k)
        return ts2, m

    agent.train_epoch = still


def _control(agent):
    precision.fp8_trunks(agent.net)


BREAKS = {"sound": None, "control": _control, "unchanged": _unchanged,
          "half_batch": ref_train.half_batch}


def _run(cell, fault, monkeypatch):
    import importlib

    c = spec.cell(cell)
    cfg = spec.config(c["config"])
    kind = importlib.import_module(f"benchmark.kinds.{cfg['kind']}")
    if BREAKS[fault] is not None:
        build = kind.build_program

        def broken(*a, **kw):
            agent, ts = build(*a, **kw)
            BREAKS[fault](agent)
            return agent, ts

        monkeypatch.setattr(kind, "build_program", broken)
    res = train.run(c, cfg, spec.traffic(c["traffic"]), kind, 2 ** 31 + 77, 0.1, False,
                    torch.device("cpu"), time.time(), lambda m: None, num_envs=CELLS[cell])
    return check.compared(res.numbers, check.limits(cell))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["sound", "unchanged", "half_batch"])
def test_correct_decides(cell, fault, monkeypatch):
    numbers = _run(cell, fault, monkeypatch)
    assert check.judge(numbers, check.limits(cell)) == (fault == "sound"), numbers


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_far_from_the_sound_run(cell, monkeypatch):
    sound = _run(cell, "sound", monkeypatch)
    control = _run(cell, "control", monkeypatch)
    assert all(control[k] > sound[k] for k in sound), (sound, control)
    assert max(control[k] / max(sound[k], 1e-12) for k in sound) >= 10, (sound, control)

