"""The port's scripts (``vid2player3d_torch/scripts``) against the JAX
package's (``scripts/*.py``), on the CPU.

The JAX scripts set `XLA_FLAGS` and a compile cache when imported, which
would reach later tests of the same worker. So the fixture writers
(`write_fixture`, `write_amass_fixture`), `collect_contacts` and local
SGD's verdict rule are taken from the files' source and executed alone
(`_jax_def`, `_jax_verdict`); `scripts/swing_quality.py`, which sets neither,
is imported by path.

Held: the fixtures' arrays byte for byte; the contacts to 1e-6; the
swing-quality numbers at `--n 2` (speeds to 1e-4 relative, the rates within
one ball: the flight runs in float32 on both sides, and a ball on a court
line may fall either way); the curriculum at a tiny depth (every leg, the
JAX artifact's report keys, the HTML); the learning checks failing on a
curve that gets worse; local SGD one epoch per mode on 4 gloo ranks (JAX's
row and report keys, finite) and its verdict rule at the margin's edge; and
every entry point raising without a card unless given the CPU.
"""

import ast
import contextlib
import io
import json
import math
import os
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

from vid2player3d_torch.scripts import e2e_curriculum as E2E
from vid2player3d_torch.scripts import local_sgd_convergence as LSGD
from vid2player3d_torch.scripts import probe_e2e_im as PROBE
from vid2player3d_torch.scripts import swing_quality as SQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = os.path.join(REPO, "scripts")


def _source(name: str) -> str:
    with open(os.path.join(JAX_SCRIPTS, name)) as f:
        return f.read()


def _jax_def(name: str, fn: str, namespace: dict):
    """The function `fn` of JAX's `scripts/<name>`, executed alone in
    `namespace` (the module's other top-level code does not run)."""
    tree = ast.parse(_source(name))
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)
    ns = dict(namespace)
    exec(compile(ast.Module(body=[node], type_ignores=[]), name, "exec"), ns)
    return ns[fn]


def _jax_verdict(a: float, b: float) -> str:
    """JAX's local-SGD verdict: the expression `main` assigns to
    `report["verdict"]`, evaluated alone on the two last-20 means."""
    tree = ast.parse(_source("local_sgd_convergence.py"))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].slice, "value", None) == "verdict"):
            return eval(compile(ast.Expression(node.value), "verdict", "eval"), {"a": a, "b": b})
    raise AssertionError("no verdict in scripts/local_sgd_convergence.py")


def _npz_members(path: str) -> dict:
    """The bytes of each array member of an .npz (the zip's own timestamps
    left out)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _same_fixture_dirs(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert _npz_members(os.path.join(a, n)) == _npz_members(os.path.join(b, n)), n


@pytest.mark.parametrize("case", ["probe_hard", "probe_easy", "e2e"])
def test_fixture_writers_match_jax(case, tmp_path):
    """The port's fixture writers give JAX's arrays, byte for byte."""
    ns = {"np": np, "os": os}
    if case == "e2e":
        jax_fn = _jax_def("e2e_curriculum.py", "write_amass_fixture", ns)
        jax_fn(str(tmp_path / "jax"))
        E2E.write_amass_fixture(str(tmp_path / "torch"))
    else:
        lo, hi = (0.3, 0.8) if case == "probe_hard" else (0.05, 0.25)
        jax_fn = _jax_def("probe_e2e_im.py", "write_fixture", ns)
        jax_fn(str(tmp_path / "jax"), lo, hi)
        PROBE.write_fixture(str(tmp_path / "torch"), lo, hi)
    _same_fixture_dirs(str(tmp_path / "jax"), str(tmp_path / "torch"))


def _jax_collect_contacts():
    from vid2player3d_tpu.data import tennis_motion as JTM

    return _jax_def("swing_quality.py", "collect_contacts",
                    {"np": np, "Skeleton": JTM.Skeleton, "grip_arrays": JTM.grip_arrays,
                     "R_WRIST": JTM.R_WRIST,
                     "generate_rally_sequence": JTM.generate_rally_sequence})


def test_collect_contacts_matches_jax():
    """collect_contacts(2, 1.0, 3): the same contacts, each position,
    velocity and face normal within 1e-6, relative (plus 1e-6 absolute near
    zero). The rest skeleton's float32 einsums differ by ~1e-7 between the
    frameworks, and the rig carries that gap through its float64 math: a
    racket head moving at 11 m/s differs by 1.2e-6 m/s."""
    ref = _jax_collect_contacts()(2, 1.0, 3)
    got = SQ.collect_contacts(2, 1.0, 3)
    assert len(got) == len(ref) > 0
    for (gp, gv, gn), (rp, rv, rn) in zip(got, ref):
        np.testing.assert_allclose(gp, rp, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gv, rv, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gn, rn, rtol=1e-6, atol=1e-6)


def test_swing_quality_matches_jax(monkeypatch, capsys):
    """`--n 2` (seed 3): JAX's script run as it is, its flight's inputs and
    result recorded; the port's numbers against the same numbers computed
    from JAX's arrays. Speeds to 1e-4 relative; net_clear and bounce_in
    within one ball; the bounce's median y to 1e-4 relative where the same
    balls clear the net. The port prints JAX's two lines."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_swing_quality",
                                                  os.path.join(JAX_SCRIPTS, "swing_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen, simulate_flight = {}, mod.B.simulate_flight

    def flight(pos0, vel0, spin0, **kw):
        seen["vel0"] = np.asarray(vel0)
        seen["traj"] = simulate_flight(pos0, vel0, spin0, **kw)
        return seen["traj"]

    monkeypatch.setattr(mod, "B", types.SimpleNamespace(simulate_flight=flight))
    monkeypatch.setattr(sys, "argv", ["swing_quality.py", "--n", "2"])
    mod.main()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    v, traj = seen["vel0"], seen["traj"]
    bp, net = np.asarray(traj.bounce_pos), np.asarray(traj.pass_net)
    land = (np.asarray(traj.has_bounce) & (np.abs(bp[:, 0]) < mod.COURT_HALF_W)
            & (bp[:, 1] > 0) & (bp[:, 1] < mod.COURT_HALF_LEN))
    ref = {"contacts": len(v),
           "head_speed_mean": float(np.mean([np.linalg.norm(c[1])
                                             for c in mod.collect_contacts(2, 1.0, 3)])),
           "out_speed_mean": float(np.linalg.norm(v, axis=1).mean()),
           "out_vz_p50": float(np.median(v[:, 2])),
           "net_clear": float(net.mean()), "bounce_in": float((net & land).mean())}

    got = SQ.main(["--n", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(jax_lines) == 2
    assert lines[0].split()[0] == jax_lines[0].split()[0] == f"contacts={ref['contacts']}"
    assert got["contacts"] == ref["contacts"] > 0
    for k in ("head_speed_mean", "out_speed_mean", "out_vz_p50"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    one_ball = 1.0 / ref["contacts"]
    for k in ("net_clear", "bounce_in"):
        assert abs(got[k] - ref[k]) <= one_ball + 1e-12, (k, got[k], ref[k])
    if got["net_clear"] == ref["net_clear"] and net.any():
        assert got["bounce_y_p50"] == pytest.approx(float(np.median(bp[net][:, 1])), rel=1e-4)


def test_e2e_curriculum_tiny_cpu(tmp_path):
    """The five legs at a tiny depth on the CPU: each command exits 0, the
    report has the JAX artifact's keys (and its sections' keys), every
    number is finite, the MotionVAE's metrics moved aside and the HTML
    rollout written."""
    torch.set_num_threads(2)
    out = str(tmp_path / "e2e")
    with contextlib.redirect_stdout(io.StringIO()):
        rep = E2E.main(out, device="cpu", im_epochs=2, im_envs=4, im_horizon=4,
                       im_minibatch=16, eval_envs=2, eval_resets=1, mvae_epochs=1,
                       mvae_batches=1, stage1_epochs=1, stage1_envs=4, stage1_horizon=4,
                       stage1_minibatch=16, render_envs=2)
    with open(os.path.join(REPO, "artifacts", "e2e", "e2e_report.json")) as f:
        ref = json.load(f)
    assert set(rep) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert set(rep[k]) == set(v), k
            assert all(math.isfinite(x) for x in rep[k].values()), (k, rep[k])
    with open(os.path.join(out, "e2e_report.json")) as f:
        assert json.load(f) == rep
    assert rep["imitation"]["epochs"] == 2 and rep["tennis_stage1"]["epochs"] == 1
    assert os.path.getsize(os.path.join(out, "rollout.html")) > 0
    assert os.path.exists(os.path.join(out, "mvae_metrics.jsonl"))


def _rows(rewards, kl=0.2):
    return [{"reward_mean": r, "kl": kl, "alive_ratio": 0.9} for r in rewards]


def test_learning_checks_fail_on_a_worse_curve():
    """A made-up 300-epoch curve that gets worse, a kl that explodes and a
    trained policy that tracks worse than pure PD each fail; a curve that
    learns passes."""
    up = E2E.imitation_summary(_rows(np.linspace(0.19, 0.22, 300)))
    E2E.check_imitation_learned(up)
    with pytest.raises(AssertionError, match="anti-learned"):
        E2E.check_imitation_learned(E2E.imitation_summary(_rows(np.linspace(0.22, 0.19, 300))))
    with pytest.raises(AssertionError, match="KL exploded"):
        E2E.check_imitation_learned(E2E.imitation_summary(_rows(np.linspace(0.19, 0.22, 300),
                                                                kl=1.5)))
    base = {"mpjpe": 4.39}
    E2E.check_tracks_better({"imitation_eval_pd_baseline": base, "imitation_eval": {"mpjpe": 4.16}})
    with pytest.raises(AssertionError, match="WORSE than pure PD"):
        E2E.check_tracks_better({"imitation_eval_pd_baseline": base,
                                 "imitation_eval": {"mpjpe": 4.5}})


def test_last_json_object_skips_earlier_braces():
    """The evaluation report is the last JSON object printed; a brace in an
    earlier line does not move the parse."""
    text = ('NOTE: set {x}\nepoch 1/2 {"a": 1}\n'
            + json.dumps({"reward_mean": 0.1, "mpjpe": 2.0}, indent=2) + "\n")
    assert E2E.last_json_object(text) == {"reward_mean": 0.1, "mpjpe": 2.0}


def test_local_sgd_one_epoch_per_mode_cpu(tmp_path):
    """One epoch per mode over 4 gloo ranks on the CPU: each mode's rows
    carry the keys of JAX's committed rows, all finite; the report has
    JAX's report keys and its verdict is one of the two."""
    out = str(tmp_path / "lsgd")
    with contextlib.redirect_stdout(io.StringIO()):
        rep = LSGD.main(epochs=1, num_envs=16, out=out, device="cpu")
    for mode in LSGD.MODES:
        with open(os.path.join(REPO, "artifacts", "local_sgd", f"{mode}.jsonl")) as f:
            ref_keys = set(json.loads(f.readline()))
        with open(os.path.join(out, f"{mode}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 1
        assert set(rows[0]) == ref_keys, set(rows[0]) ^ ref_keys
        assert all(math.isfinite(v) for v in rows[0].values()), rows[0]
    with open(os.path.join(REPO, "artifacts", "local_sgd", "report.json")) as f:
        ref = json.load(f)
    assert set(rep) == set(ref)
    assert all(set(rep[m]) == set(ref[m]) for m in LSGD.MODES)
    assert rep["verdict"] in (LSGD.verdict(1.0, 1.0), LSGD.verdict(1.0, 0.0))
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f) == rep


@pytest.mark.parametrize("sync", [0.4278, 0.5, 0.0125])
def test_local_sgd_verdict_matches_jax_at_the_edge(sync):
    """Local SGD matches when its last-20 mean is at least the synchronous
    one less 0.02: on both sides of that edge and on it, the port's verdict
    is JAX's."""
    for local in (sync - LSGD.MATCH_MARGIN, sync - LSGD.MATCH_MARGIN - 1e-6,
                  sync - LSGD.MATCH_MARGIN + 1e-6, sync, sync + 0.1, sync - 0.1):
        assert LSGD.verdict(sync, local) == _jax_verdict(sync, local), (sync, local)
    assert "matches" in LSGD.verdict(sync, sync - LSGD.MATCH_MARGIN)
    assert "WORSE" in LSGD.verdict(sync, sync - LSGD.MATCH_MARGIN - 1e-6)


@pytest.mark.parametrize("entry", ["probe_e2e_im", "e2e_curriculum", "swing_quality",
                                   "local_sgd_convergence"])
def test_entry_points_need_a_card_or_the_cpu(entry, monkeypatch, tmp_path):
    """With no card and no device each script raises before it writes
    anything; asked for the CPU it would run (the tests above)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    calls = {"probe_e2e_im": lambda: PROBE.main(out),
             "e2e_curriculum": lambda: E2E.main(out),
             "swing_quality": lambda: SQ.main(["--n", "1"]),
             "local_sgd_convergence": lambda: LSGD.main(1, 16, out)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not os.path.exists(out)
