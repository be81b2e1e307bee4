"""The port's package rules: it imports nothing of JAX, its entry points never
drop to the CPU on their own, and its K1 wrapper takes the plain version only
for CPU tensors (a CUDA tensor launches the kernel or raises).
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (the test process holds both frameworks; the port must not)
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.learn import ImitationPPO, PPOConfig
from vid2player3d_torch.ops import fused_adam as FA

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vid2player3d_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vid2player3d_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    """Every module of vid2player3d_torch, and chip_smoke.py, imported in a
    fresh interpreter: no jax, flax, optax or vid2player3d_tpu module is
    loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25, out.stdout


def test_entry_points_need_a_device_without_cuda():
    """With no CUDA device, the entry points called without `device=` raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_motion_lib(num_motions=1, T=30)
    lib = make_synthetic_motion_lib(num_motions=1, T=30, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HumanoidImEnv(HumanoidImConfig(num_envs=2), lib)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=2), lib, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8))
    assert ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8), device="cpu") \
        .device.type == "cpu"


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"use_context_ik": True},
                                {"minibatch_per_chip": True}, {"dp_sync": "per_mini_epoch"}],
                         ids=["mesh", "context_ik", "minibatch_per_chip", "dp_sync"])
def test_learner_unported_options_raise(kw):
    """A mesh, context IK, per-chip minibatches and local-SGD sync are not
    ported: asking for any of them raises instead of running without it."""
    lib = make_synthetic_motion_lib(num_motions=1, T=30, device="cpu")
    env = HumanoidImEnv(HumanoidImConfig(num_envs=2), lib, device="cpu")
    cfg_kw = {k: v for k, v in kw.items() if k != "mesh"}
    with pytest.raises(NotImplementedError):
        ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, **cfg_kw),
                     mesh=kw.get("mesh"), device="cpu")


def _leaf(n, device="cpu", mdt=torch.float32):
    p = torch.linspace(-1.0, 1.0, n, device=device)
    return (p, torch.zeros(n, dtype=mdt, device=device), torch.zeros(n, dtype=mdt, device=device),
            torch.full((n,), 0.5, device=device),
            torch.tensor([1.0, 1e-3, 0.1, 0.001], device=device))


def test_k1_wrapper_raises_on_cuda_tensor_without_card():
    """A CUDA tensor goes to the kernel: with no card (here a CUDA-typed fake
    tensor) the wrapper raises and does not fall back to the plain version;
    no launch is counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    before = FA.leaf_update.launches
    with FakeTensorMode():
        args = _leaf(8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FA.leaf_update(*args)
    assert FA.leaf_update.launches == before


def test_k1_wrapper_plain_on_cpu_and_checks():
    """CPU tensors take the plain version (no launch counted) and move by
    the Adam step; bad dtypes, sizes, layouts and devices raise."""
    before = FA.leaf_update.launches
    p, m, v, g, s = _leaf(10)
    p0 = p.clone()
    FA.leaf_update(p, m, v, g, s)
    assert FA.leaf_update.launches == before
    # first Adam step moves every element by lr·(m/c1)/(sqrt(v/c2)+eps) = lr;
    # 2e-7 is the f32 rounding of p − lr on |p| ≤ 1
    step = (0.1 * 0.5 / 0.1) / (np.sqrt(0.001 * 0.25 / 0.001) + 1e-8)
    np.testing.assert_allclose((p0 - p).numpy(), np.full(10, 1e-3 * step), atol=2e-7, rtol=0)

    with pytest.raises(TypeError):
        FA.leaf_update(*_leaf(8, mdt=torch.float16))
    p, m, v, g, s = _leaf(8)
    with pytest.raises(TypeError):
        FA.leaf_update(p.double(), m, v, g, s)
    with pytest.raises(ValueError):
        FA.leaf_update(p, m[:4], v, g, s)
    with pytest.raises(ValueError):
        FA.leaf_update(p, m, v, g, s[:3])
    p2 = torch.zeros(4, 4).t()
    with pytest.raises(ValueError):
        FA.leaf_update(p2, *(t.reshape(4, 4) for t in _leaf(16)[1:4]), s)
    with pytest.raises(ValueError):
        FA.leaf_update(*(t.to("meta") for t in _leaf(8)))
