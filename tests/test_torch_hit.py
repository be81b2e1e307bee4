"""The hitting curriculum's learner against the JAX package's, and the
checks that score the curriculum's runs.

`test_v2p_epochs_match_jax` runs four `V2PPPO.train_epoch`s of each package
at the size of tests/test_torch_v2p.py (4 envs, horizon 4, minibatch 8, 2
mini-epochs, trunks (64, 32), f32 on the CPU) under two named configs of the
curriculum, cut to that size and otherwise as registered (their rewards,
basins, ball spread, substeps and lr schedule):

- `federer_train_stage_1a`: the reach reward with the wide basins and the
  narrow ball spread (`ball_bounce_x_half=1.0`), from the JAX learner's
  initial params;
- `federer_train_stage_2a`: `return_w_estimate` with the `quality` term, 6
  substeps, the narrow spread, warm-started as the command line does
  (`load_stage_checkpoint(discard_sigma=True)`) from each package's own
  stage-1a checkpoint after two epochs.

Each epoch is fed the JAX epoch's draws (its key splits replayed as
tests/test_torch_v2p.py replays them). After every epoch the lr, the epoch
counter, both running norms, every metric (at test_torch_v2p.py's bounds),
the params (within twice the sum of the optimizer steps' lr so far, as
tests/test_torch_learning.py holds the imitation learner) and the Adam count
(exact) match the JAX learner's, and no update was skipped.

The other tests hold `chip_smoke.py`'s scoring of the curriculum's runs
(`hit_checks`, checks H1-H6 of `artifacts/torch_tennis_hit/README.md`) to
the JAX package's own committed runs, which pass it, and to the port's
earlier stage-1 run, whose hit rate of ~0.001 fails it.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_tennis import _port_spec, _state_arrays
from test_torch_tennis_env import make_shared, reset_draws
from test_torch_v2p import METRIC_ATOL, _draws
from vid2player3d_tpu.cli.configs import CONFIGS as JCONFIGS
from vid2player3d_tpu.envs import TennisEnv as JEnv
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.cli.configs import CONFIGS
from vid2player3d_torch.envs import TennisEnv
from vid2player3d_torch.learn import V2PPPO
from vid2player3d_torch.utils import checkpoint as CK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

N, T, MB, MINI_EPOCHS, SEED, EPOCHS, WARM_EPOCHS = 4, 4, 8, 2, 3, 4, 2
STEPS = MINI_EPOCHS * (N * T // MB)
# the curriculum's configs at test size: short episodes and reactions so the
# four epochs see resets, reactions and the candidate reset path
ENV_CUT = dict(num_envs=N, max_episode_length=10, reset_reaction_nframes=6, reset_candidates=2)
LEARNER_CUT = dict(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS,
                   actor_units=(64, 32), critic_units=(64, 32), compute_dtype="f32")


def _pair(shared, name):
    """(JAX env, port env, JAX learner config, port learner config) of the
    named config cut to the test's size."""
    jspec, feats, jgen, jfrozen, tfrozen = shared
    jcfg = dataclasses.replace(JCONFIGS[name].env_tennis, **ENV_CUT)
    tcfg = dataclasses.replace(CONFIGS[name].env_tennis, **ENV_CUT)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
    pi_low, pi_params = jfrozen.as_pi_low()
    jenv = JEnv(jcfg, jspec, feats, ball_generator=jgen, pi_low=pi_low,
                pi_low_params=pi_params)
    tenv = TennisEnv(tcfg, _port_spec(jspec), feats,
                     ball_generator=CK.ball_pool_from_jax(jgen, device="cpu"),
                     pi_low=tfrozen.as_pi_low(), device="cpu")
    jl = dataclasses.replace(JCONFIGS[name].v2p, **LEARNER_CUT)
    tl = dataclasses.replace(CONFIGS[name].v2p, **LEARNER_CUT)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl), name
    return jenv, tenv, jl, tl


def _snapshot(ts, port):
    """What the test holds of a train state, as numpy: params, both running
    norms, epoch, lr and the Adam count."""
    if port:
        params = {k: v.detach().numpy().copy() for k, v in ts.params.items()}
        norms = {n: [getattr(getattr(ts, n), f).numpy().copy() for f in ("n", "mean", "var")]
                 for n in ("obs_norm", "val_norm")}
        return dict(params=params, norms=norms, epoch=int(ts.epoch), lr=float(ts.lr),
                    count=int(ts.opt_state.count))
    params = {k: v.numpy() for k, v in CK.params_from_jax(_flatten(ts.params)).items()}
    norms = {n: [np.asarray(getattr(getattr(ts, n), f)).copy() for f in ("n", "mean", "var")]
             for n in ("obs_norm", "val_norm")}
    return dict(params=params, norms=norms, epoch=int(ts.epoch), lr=float(ts.lr),
                count=int(CK.adam_state_from_jax(_flatten({"opt_state": ts.opt_state}))[2]))


def _port_env_from_jax(tts, jts):
    """The port's state takes the JAX state's env state and last obs."""
    tts.env_state = CK.tennis_state_from_jax(_state_arrays(jts.env_state))
    tts.last_obs = torch.tensor(np.asarray(jts.last_obs))
    return tts


def _run(jagent, tagent, jts, tts, epochs, lr_sum, save=None):
    """`epochs` epochs of both learners, the port fed the JAX epoch's
    draws; per epoch (JAX metrics, port metrics, JAX snapshot, port
    snapshot, the sum of every optimizer step's lr so far). `save` (epoch,
    JAX path, port path) writes both checkpoints after that epoch."""
    rows = []
    for e in range(1, epochs + 1):
        draws = _draws(jagent, jts)
        lr_sum += STEPS * float(jts.lr)        # a constant lr through the epoch
        jts, jm = jagent.train_epoch(jts)
        tts, tm = tagent.train_epoch(tts, draws=draws)
        rows.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()},
                     _snapshot(jts, False), _snapshot(tts, True), lr_sum))
        if save is not None and e == save[0]:
            jagent.save_checkpoint(save[1], jts)
            tagent.save_checkpoint(save[2], tts)
    return rows


@pytest.fixture(scope="module")
def shared():
    return make_shared()


@pytest.fixture(scope="module")
def stage1a(shared, tmp_path_factory):
    """Four stage-1a epochs of both learners from the JAX learner's initial
    params and env state; both checkpoints after the second epoch."""
    jenv, tenv, jl, tl = _pair(shared, "federer_train_stage_1a")
    jagent = JV2P(jenv, jl, seed=SEED)
    tagent = V2PPPO(tenv, tl, seed=SEED, device="cpu")
    jts = jagent.init_state()
    tts = _port_env_from_jax(
        tagent.init_state(params=CK.params_from_jax(_flatten(jts.params))), jts)
    start = (_snapshot(jts, False), _snapshot(tts, True))
    d = tmp_path_factory.mktemp("stage1a")
    paths = (str(d / "jax.npz"), str(d / "port.npz"))
    rows = _run(jagent, tagent, jts, tts, EPOCHS, 0.0, save=(WARM_EPOCHS,) + paths)
    return dict(name="federer_train_stage_1a", start=start, rows=rows, paths=paths,
                lr=tl.learning_rate)


@pytest.fixture(scope="module")
def stage2a(shared, stage1a):
    """Four stage-2a epochs of both learners, each warm-started from its own
    stage-1a checkpoint as the command line does, the port's envs in the
    JAX learner's reset state."""
    name = "federer_train_stage_2a"
    assert CONFIGS[name].warm_start == "federer_train_stage_1"
    assert CONFIGS[name].discard_pretrained_sigma
    jenv, tenv, jl, tl = _pair(shared, name)
    jagent = JV2P(jenv, jl, seed=SEED)
    tagent = V2PPPO(tenv, tl, seed=SEED, device="cpu")
    jts = jagent.load_stage_checkpoint(stage1a["paths"][0], discard_sigma=True)
    k_env, _ = jax.random.split(jax.random.PRNGKey(SEED))
    tts = _port_env_from_jax(tagent.load_stage_checkpoint(
        stage1a["paths"][1], discard_sigma=True,
        reset_draws=reset_draws(jenv, k_env, N)), jts)
    start = (_snapshot(jts, False), _snapshot(tts, True))
    lr_sum = stage1a["rows"][WARM_EPOCHS - 1][4]
    rows = _run(jagent, tagent, jts, tts, EPOCHS, lr_sum)
    return dict(name=name, start=start, rows=rows, lr=tl.learning_rate,
                lr_sum0=lr_sum)


def _close(got, want, atol, what):
    """|got - want| <= atol + 1e-4·|want| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= atol + 1e-4 * np.abs(want)), (what, float(err.max()))


def _hold_state(js, ts, atol_params, what):
    assert ts["epoch"] == js["epoch"], what
    assert ts["count"] == js["count"], what
    _close(ts["lr"], js["lr"], METRIC_ATOL["lr"], f"{what} lr")
    for name in ("obs_norm", "val_norm"):
        assert float(ts["norms"][name][0]) == float(js["norms"][name][0]), (what, name)
        for i, f in ((1, "mean"), (2, "var")):
            _close(ts["norms"][name][i], js["norms"][name][i], 1e-4, f"{what} {name}.{f}")
    assert ts["params"].keys() == js["params"].keys()
    for k, v in js["params"].items():
        np.testing.assert_allclose(ts["params"][k], v, atol=atol_params, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("stage", ["stage1a", "stage2a"])
def test_v2p_epochs_match_jax(request, stage):
    """Four epochs under the curriculum config: after every epoch the lr
    (the config's constant), the epoch counter, both running norms, every
    metric (`hit_rate`, `contact_rate`, `quality_reward` among them), the
    params within 2·Σlr, the exact Adam count and `grad_skip` 0 match the JAX
    learner's. Stage 2a begins from the warm start: the stage-1a epoch
    counter, Adam state and running norms carried, the lr the new config's,
    the params the checkpoint's."""
    run = request.getfixturevalue(stage)
    js0, ts0 = run["start"]
    e0 = 0 if stage == "stage1a" else WARM_EPOCHS
    lr_sum = run.get("lr_sum0", 0.0)
    assert ts0["epoch"] == js0["epoch"] == e0
    assert ts0["count"] == js0["count"] == e0 * STEPS
    assert ts0["lr"] == js0["lr"] == np.float32(run["lr"])
    _hold_state(js0, ts0, 2 * lr_sum if lr_sum else 0.0, f"{stage} start")
    if stage == "stage2a":
        assert {"quality_reward", "ball_pos_reward"} <= set(run["rows"][0][0])
    for e, (jm, tm, js, ts, lr_sum) in enumerate(run["rows"], start=1):
        what = f"{stage} epoch {e}"
        assert set(tm) == set(jm), what
        for k in jm:
            _close(tm[k], jm[k], METRIC_ATOL.get(k, 1e-5), f"{what} {k}")
        assert tm["grad_skip"] == 0.0 == jm["grad_skip"], what
        assert js["epoch"] == e0 + e and js["count"] == (e0 + e) * STEPS, what
        assert tm["lr"] == np.float32(run["lr"]), what
        _hold_state(js, ts, 2 * lr_sum, what)


# -- the scoring of the curriculum's runs (chip_smoke.hit_checks) ----------------

JAX_HIT = os.path.join(ROOT, "artifacts", "tennis_hit")
JAX_SERVE = os.path.join(ROOT, "artifacts", "serve_practice")


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _report(path):
    with open(path) as f:
        return json.load(f)


def _jax_runs():
    """The JAX package's committed curriculum runs as `hit_checks` takes
    them. Its files predate `grad_skip` and the evaluations' baseline, so
    those parts are given as absent."""
    legs = {"stage1a": _rows(os.path.join(JAX_HIT, "stage1a_narrow_metrics.jsonl")),
            "stage1": _rows(os.path.join(JAX_HIT, "stage1b_metrics.jsonl")),
            "stage2a": _rows(os.path.join(JAX_HIT, "stage2a_metrics.jsonl"))}
    evals = {"stage1_full": _report(os.path.join(JAX_HIT, "stage1_eval_report.json")),
             "stage2a_narrow": _report(os.path.join(JAX_HIT, "stage2a_eval_report.json")),
             "stage2a_full": _report(os.path.join(JAX_HIT,
                                                  "stage2a_eval_report_full_spread.json"))}
    return legs, evals


def test_hit_checks_pass_on_the_jax_runs():
    """H1-H6 on the JAX package's own runs of the curriculum and of serve
    practice: every check met (the baseline's 3× clause of H4 needs an
    untrained policy's evaluation, which the JAX runs lack)."""
    legs, evals = _jax_runs()
    res = chip_smoke.hit_checks(legs, evals, baseline=None)
    assert all(r["met"] for r in res.values()), res
    assert set(res) == {"H1", "H2", "H3", "H4", "H5", "H6"}
    assert res["H1"]["value"] == pytest.approx(0.0423, abs=5e-5)
    serve = chip_smoke.serve_checks(_rows(os.path.join(JAX_SERVE, "metrics.jsonl")),
                                    _report(os.path.join(JAX_SERVE, "eval_report.json")))
    assert all(r["met"] for r in serve.values()), serve
    assert serve["S1"]["value"] == pytest.approx(0.0306, abs=5e-4)


def test_hit_checks_fail_on_the_chain_run():
    """The port's stage-1 chain run (hit_rate ~0.001 over 250 epochs) in the
    place of stage 1 misses H2; every metric there is finite, so H6 holds."""
    legs, evals = _jax_runs()
    legs["stage1"] = _rows(os.path.join(ROOT, "artifacts", "torch_tennis_chain",
                                        "stage1_metrics.jsonl"))
    res = chip_smoke.hit_checks(legs, evals, baseline=None)
    assert not res["H2"]["met"] and res["H2"]["value"] < 0.002
    assert res["H6"]["met"]
    legs["stage1a"] = legs["stage1"]
    res = chip_smoke.hit_checks(legs, evals, baseline=None)
    assert not res["H1"]["met"]


def test_hit_checks_catch_a_bad_report():
    """H4 misses an evaluation of too few cycles or under 3× the untrained
    baseline's rate; H5 misses a report without JAX's six keys or whose
    `bounce_pos_error` is set while nothing bounced in; H6 misses a
    non-finite metric or a skipped update."""
    legs, evals = _jax_runs()
    base = {"cycles": 3000, "hit_rate": 0.01, "bounce_in_rate": 0.0, "bounce_pos_error": None,
            "fh_ratio": 0.5, "reward_mean": 1e-5}
    res = chip_smoke.hit_checks(legs, evals, baseline=base)
    assert res["H4"]["met"] is False        # 0.0203 < 3 × 0.01
    evals2 = dict(evals, stage2a_full=dict(evals["stage2a_full"], cycles=1200))
    assert not chip_smoke.hit_checks(legs, evals2, baseline=None)["H4"]["met"]
    evals3 = dict(evals, stage2a_full=dict(evals["stage2a_full"], bounce_pos_error=3.0))
    assert not chip_smoke.hit_checks(legs, evals3, baseline=None)["H5"]["met"]
    evals4 = dict(evals, stage1_full={k: v for k, v in evals["stage1_full"].items()
                                      if k != "fh_ratio"})
    assert not chip_smoke.hit_checks(legs, evals4, baseline=None)["H5"]["met"]
    legs2 = dict(legs, stage2a=legs["stage2a"][:-1] + [dict(legs["stage2a"][-1],
                                                             kl=float("nan"))])
    assert not chip_smoke.hit_checks(legs2, evals, baseline=None)["H6"]["met"]
    legs3 = dict(legs, stage1=legs["stage1"][:-1] + [dict(legs["stage1"][-1], grad_skip=0.5)])
    assert not chip_smoke.hit_checks(legs3, evals, baseline=None)["H6"]["met"]
