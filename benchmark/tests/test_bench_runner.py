"""The runner's refusals, the no-JAX check, and files found by name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import nojax, spec

ROOT = spec.ROOT


def _run(cwd, *extra):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "amass_im.train",
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_nojax_finds_a_planted_import():
    assert nojax.found(["os", "jax.numpy", "torch"]) == ["jax"]
    assert nojax.found(["vid2player3d_tpu.envs", "optax"]) == ["optax", "vid2player3d_tpu"]
    # the port's name begins with the JAX package's: whole names are compared
    assert nojax.found(["vid2player3d_torch", "vid2player3d_torch.envs", "jaxtyping"]) == []


def test_the_port_and_the_harness_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.calibrate, benchmark.kinds.im, "
            "benchmark.kinds.tennis, benchmark.entries.train; "
            "import vid2player3d_torch.cli.run, vid2player3d_torch.learn, "
            "vid2player3d_torch.envs; "
            "from benchmark import nojax; print(nojax.found())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_planted_jax_import_is_found_in_a_process():
    pytest.importorskip("jax")
    code = "import jax; from benchmark import nojax; print(nojax.found())"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert "'jax'" in out.stdout


def test_a_traffic_file_added_in_a_copy_is_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b["workloads"].append({"name": "amass_im.train_short", "config": "amass_im",
                           "traffic": "train_short", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "benchmark" / "traffic" / "train_short.json").write_text(
        json.dumps({"entry": "train", "why": "one checked epoch", "checked_epochs": 1}))
    code = ("from benchmark import spec; c = spec.cell('amass_im.train_short'); "
            "print(spec.traffic(c['traffic'])['checked_epochs'], spec.config(c['config'])['name'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.split() == ["1", "amass_im"], out.stderr
