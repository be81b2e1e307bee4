"""The port's tracer (``vid2player3d_torch/utils/trace.py``) on the CPU, where
each `StaticGraph` runs its step as it is and a part records host ns.

- Off (the default): the graphed epoch's graphs take the keys and captures
  an untraced program takes, and no part records anything; the phases are
  recorded all the same.
- On: the report holds every phase with its parent and the epoch's index,
  every part of the step and update bodies inside its phase, and the
  replays of one epoch (the horizon, mini-epochs × minibatches).
- The tracer's host spans start just after their `record_function`
  events in a profiled run, within 50 µs at the median: both are on
  `time.time_ns()`'s clock.
- The tennis parts (`masked_reset`, `serve`, `two_hand`, `estimate_out`,
  `handoff`) in the dual rally's step graph.
- The command line's `--trace` (the `trace/` keys, the events in a
  `--profile` trace), the benchmark's readers (None on the CPU, values from
  a stub report), the report's flat keys and chrome events.

This file imports no JAX.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.learn import ImitationPPO, PPOConfig
from vid2player3d_torch.utils import graphs, trace

torch.set_num_threads(1)

HORIZON, MINIBATCH, MINI_EPOCHS, ENVS = 4, 8, 2, 4
STEP_PARTS = {"policy", "env", "physics", "record"}
UPDATE_PARTS = {"gather", "forward", "backward", "optimizer"}
PHASES = {"epoch": None, "rollout": "epoch", "reset": "rollout", "prepare": "epoch",
          "update": "epoch", "finish": "epoch"}
READERS = ("update_forward_ms_per_opt_step.train", "update_backward_ms_per_opt_step.train",
           "update_optimizer_ms_per_opt_step.train", "step_physics_ms_per_step.train",
           "outside_graphs_share.train", "host_syncs_per_epoch.train")


@pytest.fixture
def tracer():
    """The process's tracer, emptied, and off again after the test."""
    t = trace.tracer
    was_on = t.on
    t.epochs.clear()
    yield t
    t.enable(was_on)
    t.epochs.clear()


def _agent():
    lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device="cpu")
    env = HumanoidImEnv(HumanoidImConfig(num_envs=ENVS, substeps=2), lib, device="cpu")
    return ImitationPPO(env, PPOConfig(horizon=HORIZON, minibatch_size=MINIBATCH,
                                       mini_epochs=MINI_EPOCHS), seed=7, device="cpu")


def _epochs(agent, n, ts=None):
    ts = agent.init_state() if ts is None else ts
    for _ in range(n):
        ts, _ = agent._train_epoch_graphed(ts)
    return ts


def _check_phases(rep, index):
    spans = {s["name"]: s for s in rep["spans"]}
    assert set(spans) == set(PHASES)
    for name, s in spans.items():
        assert s["epoch"] == index
        assert s["parent"] == PHASES[name]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    return spans


def test_tracing_off_keeps_the_graphs_keys_and_records_no_part(tracer):
    agent = _agent()
    ts = _epochs(agent, 2)
    st = agent._st
    assert st.step.key == graphs.tensor_key(list(ts.params.values()))
    assert st.update.key == graphs.tensor_key(list(ts.params.values()) + ts.opt_state.mu
                                              + ts.opt_state.nu)
    steps = MINI_EPOCHS * agent.num_minibatches
    assert (st.step.captures, st.update.captures) == (1, 1)
    assert (st.step.replays, st.update.replays) == (2 * HORIZON - 1, 2 * steps - 1)
    assert not getattr(st.step, "trace_host", []) and not getattr(st.update, "trace_host", [])
    reps = tracer.report()
    assert [r["epoch"] for r in reps] == [0, 1]
    for i, rep in enumerate(reps):
        _check_phases(rep, i)
        assert rep["parts_clock"] is None and "graphs" not in rep
        assert "host_syncs" not in rep and "outside_graphs_share" not in rep
        assert not any("device_start_ns" in s for s in rep["spans"])
    assert not any(k.startswith("trace/host.step") for k in trace.flat(reps[-1]))


def test_tracing_on_reports_phases_parts_and_replays(tracer):
    agent = _agent()
    ts = _epochs(agent, 1)
    tracer.enable(True)
    _epochs(agent, 2, ts)
    tracer.enable(False)
    st = agent._st
    assert st.step.key[0] == "traced" and (st.step.captures, st.update.captures) == (2, 2)
    rec, rep = tracer.epochs[-1], tracer.report()[-1]
    assert rep["epoch"] == 2 and rep["parts_clock"] == "host" and rep["device"] == "cpu"
    spans = _check_phases(rep, 2)
    steps = MINI_EPOCHS * agent.num_minibatches
    g = rep["graphs"]
    assert (g["step"]["replays"], g["step"]["captures"], g["step"]["rows"]) == (HORIZON, 0, HORIZON)
    assert (g["update"]["replays"], g["update"]["rows"]) == (steps, steps)
    assert set(g["step"]["parts"]) == STEP_PARTS
    assert set(g["update"]["parts"]) == UPDATE_PARTS
    for graph, parts in (("step", STEP_PARTS), ("update", UPDATE_PARTS)):
        for p in parts:
            got = g[graph]["parts"][p]
            assert got["count"] == g[graph]["rows"] and got["per_replay_ms"] > 0
    # `physics` runs inside `env`: its self time leaves the physics out
    env = g["step"]["parts"]["env"]
    assert env["self_per_replay_ms"] == pytest.approx(
        env["per_replay_ms"] - g["step"]["parts"]["physics"]["per_replay_ms"])
    # every part of a replay inside its phase's interval
    phase = {"step": spans["rollout"], "update": spans["update"]}
    for name, replays in trace._replays(rec, lambda t: t).items():
        for row in replays:
            for _, s, e, _ in row:
                assert phase[name]["start_ns"] <= s <= e <= phase[name]["end_ns"]
    out = rep["outside_graphs_ms"]
    assert out["total"] == pytest.approx(sum(v for k, v in out.items() if k != "total"))
    assert 0 < rep["outside_graphs_share"] < 1
    assert rep["outside_graphs_share"] == pytest.approx(out["total"] / rep["epoch_ms"])
    flat = trace.flat(rep)
    assert flat["trace/host.update.forward_ms_per_replay"] > 0
    assert not any(k.startswith("trace/device.") for k in flat)


def test_tracer_spans_start_at_their_profiler_events(tracer):
    """The host spans are on the clock of kineto's `start_ns()`: over three
    profiled epochs each `rollout` and `update` span starts after its
    `record_function` event (its start is read once the range is open),
    and within 50 µs of it at the median (a process descheduled between
    the two reads puts one pair further apart)."""
    from torch.profiler import ProfilerActivity, profile

    agent = _agent()
    ts = _epochs(agent, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epochs(agent, 3, ts)
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name() in trace.PROFILED)
    spans = sorted((s["start_ns"], s["name"]) for r in tracer.report()[1:] for s in r["spans"]
                   if s["name"] in trace.PROFILED)
    assert [n for _, n in events] == [n for _, n in spans] == ["rollout", "update"] * 3
    gaps = [mine - theirs for (mine, _), (theirs, _) in zip(spans, events)]
    assert min(gaps) >= 0 and sorted(gaps)[len(gaps) // 2] < 50_000, gaps


def test_dual_tennis_step_reports_the_tennis_parts(tracer):
    from vid2player3d_torch.envs import DualTennisEnv, TennisConfig
    from vid2player3d_torch.learn import FrozenImitator, V2PConfig, V2PPPO
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    feats = (np.random.default_rng(0).standard_normal((64, 288)) * 0.05).astype(np.float32)
    feats[:, 2] = 0.95
    specs = (dataclasses.replace(P.make_random_spec(0, player="nadal", hidden=64, experts=3,
                                                    device="cpu"), righthand=False),
             P.make_random_spec(1, player="federer", hidden=64, experts=3, device="cpu"))
    env = DualTennisEnv(TennisConfig(num_envs=4, substeps=2, reset_candidates=0), specs,
                        (feats, feats), ball_generator=TennisBallGenerator(num_candidates=256,
                                                                           device="cpu"),
                        pi_low=FrozenImitator.zeros(device="cpu"),
                        pi_low_b=FrozenImitator.zeros(device="cpu"),
                        two_hand_lanes=(True, False), device="cpu")
    agent = V2PPPO(env, V2PConfig(horizon=2, minibatch_size=8, mini_epochs=1, num_policies=2,
                                  actor_units=(64, 16), critic_units=(64, 16)), device="cpu")
    tracer.enable(True)
    ts = agent.init_state()
    for _ in range(2):
        ts, _ = agent._train_epoch_graphed(ts)
    tracer.enable(False)
    rep = tracer.report()[-1]
    spans = {s["name"]: s["parent"] for s in rep["spans"]}
    assert spans == {k: v for k, v in PHASES.items() if k != "reset"}
    step = rep["graphs"]["step"]
    assert step["replays"] == 2
    assert set(step["parts"]) == STEP_PARTS | {"masked_reset", "serve", "two_hand",
                                               "estimate_out", "handoff"}
    assert set(rep["graphs"]["update"]["parts"]) == UPDATE_PARTS


def _stub_report():
    return {"parts_clock": "device", "outside_graphs_share": 0.012, "host_syncs": 0,
            "graphs": {"update": {"parts": {p: {"per_replay_ms": v} for p, v in (
                ("gather", 0.05), ("forward", 0.3), ("backward", 0.4), ("optimizer", 0.5))}},
                "step": {"parts": {"physics": {"per_replay_ms": 12.5}}}}}


def test_benchmark_readers_read_the_tracer(tracer):
    from benchmark.metrics import reader

    cpu = SimpleNamespace(agent=_agent())
    assert [reader(n)(cpu) for n in READERS] == [None] * len(READERS)
    assert cpu.port_trace is None and not tracer.on
    stub = SimpleNamespace(agent=None, port_trace=_stub_report())
    assert [reader(n)(stub) for n in READERS] == pytest.approx([0.35, 0.4, 0.5, 12.5, 0.012, 0])
    part_missing = SimpleNamespace(agent=None, port_trace={"graphs": {}})
    assert [reader(n)(part_missing) for n in READERS] == [None] * len(READERS)


def test_chrome_events_join_a_profiler_trace(tracer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    agent = _agent()
    ts = _epochs(agent, 1)
    tracer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _epochs(agent, 1, ts)
    tracer.enable(False)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    n = trace.append_chrome_events(path, [tracer.epochs[-1]])
    with open(path) as f:
        doc = json.load(f)
    ours = [e for e in doc["traceEvents"] if e.get("pid") == "port tracer"]
    assert len(ours) == n > 0
    kineto = {e["name"]: e["ts"] for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"] in trace.PROFILED}
    mine = {e["name"]: e["ts"] for e in ours if e["tid"] == "phases (host)"}
    assert set(kineto) == set(trace.PROFILED)
    for name, ts_us in kineto.items():
        # the file's time base (whole seconds) and unit (µs) taken right: a
        # slip in either is off by a second or a factor of 1,000; the
        # clock itself is held to 50 µs in the test above
        assert abs(mine[name] - ts_us) < 10_000, name
    assert {e["name"] for e in ours if e["tid"] == "update parts (host)"} == UPDATE_PARTS


def test_cli_trace_logs_trace_keys(tracer, tmp_path, monkeypatch):
    from vid2player3d_torch.cli.run import main

    monkeypatch.setattr(ImitationPPO, "graphed", property(lambda self: True))
    out = str(tmp_path / "run")
    prof = str(tmp_path / "prof")
    rc = main(["--cfg", "amass_im", "--num_envs", "4", "--horizon", "4", "--minibatch_size", "8",
               "--epochs", "4", "--out", out, "--device", "cpu", "--trace", "--profile", prof])
    assert rc in (0, None) and not tracer.on
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 4
    for row in rows:
        assert row["trace/host.update_ms"] > 0 and row["trace/step.replays"] >= HORIZON - 1
        assert row["trace/host.update.forward_ms_per_replay"] > 0
        assert not any(k.startswith("trace/device.") for k in row)
    with open(os.path.join(prof, "trace.json")) as f:
        doc = json.load(f)
    epochs = {e["args"]["epoch"] for e in doc["traceEvents"] if e.get("pid") == "port tracer"}
    assert epochs == {1, 2, 3}
