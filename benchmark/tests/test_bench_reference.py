"""The frozen reference matches the port at a tiny size on the CPU, for each
kind of configuration the harness builds: the same inputs, weights and
draws give the same first epoch (there both compute in float32; the
reference keeps Adam's moments in bf16, as the configurations state for the
card, so the params part after the first optimizer step)."""

import importlib
import tempfile

import pytest
import torch

from benchmark import check, spec
from benchmark.entries.train import checked_epochs
from benchmark.reference import train as ref_train

KINDS = {"amass_im": 8, "federer_train_stage_1": 16}


@pytest.mark.parametrize("config", sorted(KINDS))
def test_reference_matches_the_port(config):
    cfg = spec.config(config)
    kind = importlib.import_module(f"benchmark.kinds.{cfg['kind']}")
    traffic = {**spec.traffic("train"), "checked_epochs": 1}
    dev = torch.device("cpu")
    with tempfile.TemporaryDirectory() as work:
        inputs = kind.make_inputs(cfg, 2 ** 31 + 5, work)
        _, _, prog, params0 = checked_epochs(kind, cfg, traffic, inputs, dev, KINDS[config])
        ref = ref_train.run_epochs(kind, cfg, inputs, params0, 1, dev, num_envs=KINDS[config])
    assert prog["rewards"] == ref["rewards"]
    numbers = check.train_numbers(prog, ref, params0)
    assert numbers["loss_gap.e1"] < 1e-3, numbers
    assert numbers["step_gap.e1"] < 1e-2, numbers


def test_the_inputs_depend_on_the_seed_alone():
    cfg = spec.config("amass_im")
    kind = importlib.import_module("benchmark.kinds.im")
    a = kind.initial_params(cfg, 2 ** 31 + 9, "cpu")
    b = kind.initial_params(cfg, 2 ** 31 + 9, "cpu")
    c = kind.initial_params(cfg, 2 ** 31 + 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["actor_mlp.0.weight"], c["actor_mlp.0.weight"])
