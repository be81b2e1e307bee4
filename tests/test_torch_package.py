"""The port's package rules: it imports nothing of JAX, its entry points never
drop to the CPU on their own, and its kernel wrappers (K1 fused clip+Adam, K2
moe_linear, K3 fk_chain) take their plain versions only for CPU tensors (a
CUDA tensor launches the kernel or raises).
"""

import ast
import importlib
import os
import subprocess
import sys
import types

import jax  # noqa: F401  (the test process holds both frameworks; the port must not)
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import (DualTennisEnv, HumanoidImConfig, HumanoidImEnv,
                                      TennisConfig, TennisEnv)
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.ops import fk as FK
from vid2player3d_torch.ops import fused_adam as FA
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import TennisBallGenerator

# the K2 module (the package binds the function `moe_linear` over its name)
MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

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
# the modules of slice 4 (domain randomization, the corrupted-context IK)
new = {"vid2player3d_torch.envs.domain_rand", "vid2player3d_torch.envs.corrupt",
       "vid2player3d_torch.envs.presets", "vid2player3d_torch.core.ik",
       # slice 5: MotionVAE training and its harness
       "vid2player3d_torch.mvae.dataset", "vid2player3d_torch.mvae.train",
       "vid2player3d_torch.mvae.eval",
       # slice 6: the command line, eval, the HTML renderer, the native backend
       "vid2player3d_torch.cli", "vid2player3d_torch.cli.configs",
       "vid2player3d_torch.cli.run", "vid2player3d_torch.__main__",
       "vid2player3d_torch.eval", "vid2player3d_torch.vis", "vid2player3d_torch.vis.render",
       "vid2player3d_torch.native", "vid2player3d_torch.native.ballsim",
       "vid2player3d_torch.tennis.pool",
       # slice 7: data parallelism over torch.distributed
       "vid2player3d_torch.parallel", "vid2player3d_torch.parallel.mesh",
       "vid2player3d_torch.parallel.dryrun",
       # slice 8: the host-side data tools
       "vid2player3d_torch.physics.spatial", "vid2player3d_torch.core.fbx",
       "vid2player3d_torch.data.tennis_motion", "vid2player3d_torch.data.amass",
       # slice 9: the engine's golden-physics probes
       "vid2player3d_torch.physics.probes",
       # slice 16: the system's own scripts
       "vid2player3d_torch.scripts", "vid2player3d_torch.scripts.probe_e2e_im",
       "vid2player3d_torch.scripts.e2e_curriculum", "vid2player3d_torch.scripts.swing_quality",
       "vid2player3d_torch.scripts.local_sgd_convergence"}
assert new <= set(names), new - set(names)
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
    assert n_modules >= 32, out.stdout


SUBPACKAGES = ("cli", "core", "data", "envs", "learn", "mvae", "native", "ops", "parallel",
               "physics", "tennis", "utils", "vis")


def _init_names(pkg) -> set:
    """The names a package's `__init__.py` binds: its imports and `__all__`."""
    tree = ast.parse(open(pkg.__file__).read())
    names = set(getattr(pkg, "__all__", ()))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names - {"annotations"}


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return "module"
    if isinstance(obj, type):
        return "class"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    """Every name the JAX subpackage's `__init__` binds resolves in the
    port's subpackage to an object of the same kind (module, class,
    function, or a value of the same type), and the port's `__all__`, where
    JAX has one, holds JAX's."""
    jpkg = importlib.import_module(f"vid2player3d_tpu.{sub}")
    tpkg = importlib.import_module(f"vid2player3d_torch.{sub}")
    names = _init_names(jpkg)
    assert names
    for name in sorted(names):
        assert hasattr(tpkg, name), f"vid2player3d_torch.{sub} lacks {name}"
        assert _kind(getattr(tpkg, name)) == _kind(getattr(jpkg, name)), name
    if hasattr(jpkg, "__all__"):
        assert set(jpkg.__all__) <= set(tpkg.__all__), set(jpkg.__all__) - set(tpkg.__all__)


def test_ops_binds_the_moe_linear_function():
    """`vid2player3d_torch.ops.moe_linear` is the K2 function, as in JAX,
    and matches `moe_linear_ref` on a small CPU case (f32 rounding, 1e-5);
    importing `ops` builds and loads no kernel."""
    import vid2player3d_torch.ops as ops

    assert callable(ops.moe_linear) and ops.moe_linear is MOE.moe_linear
    assert ops.moe_linear_ref is MOE.moe_linear_ref
    probe = ("import importlib, vid2player3d_torch.ops; "
             "m = importlib.import_module('vid2player3d_torch.ops.moe_linear'); "
             "print(m._lib.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.split() == ["0"], out.stdout + out.stderr
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(5, 12).astype(np.float32))
    coeff = torch.softmax(torch.tensor(rng.randn(5, 3).astype(np.float32)), dim=-1)
    w = torch.tensor(rng.randn(3, 12, 7).astype(np.float32))
    b = torch.tensor(rng.randn(3, 7).astype(np.float32))
    torch.testing.assert_close(ops.moe_linear(x, coeff, w, b), ops.moe_linear_ref(x, coeff, w, b),
                               atol=1e-5, rtol=1e-5)


def test_build_humanoid_model_positional_gender():
    """A call written for JAX, `build_humanoid_model(body, betas, gender)`,
    builds the JAX model's arrays (1e-6, as the asset test) and ignores the
    gender, as JAX does."""
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.physics.asset import build_humanoid_model
    from vid2player3d_tpu.core import smpl as JS
    from vid2player3d_tpu.physics.asset import build_humanoid_model as j_build

    betas = (np.random.RandomState(3).randn(3, 10) * 0.5).astype(np.float32)
    gender = np.array([0, 1, 2])
    jm = j_build(JS.make_synthetic_smpl(), betas, gender)
    tm = build_humanoid_model(S.make_synthetic_smpl(), betas, gender, device="cpu")
    plain = build_humanoid_model(S.make_synthetic_smpl(), betas, device="cpu")
    for f in ("joint_pos", "body_com", "body_mass", "body_inertia", "kp", "kd", "torque_lim",
              "armature", "contact_offset", "contact_radius"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
        assert torch.equal(getattr(tm, f), getattr(plain, f)), f


def test_build_library_force_rebuilds():
    """`build_library(force=True)` compiles again over a current library:
    its modification time moves, and the rebuilt library loads."""
    import shutil

    from vid2player3d_torch.native import ballsim

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    path = ballsim.build_library()
    before = os.stat(path).st_mtime_ns
    assert ballsim.build_library() == path and os.stat(path).st_mtime_ns == before
    assert ballsim.build_library(force=True) == path
    assert os.stat(path).st_mtime_ns > before
    assert ballsim.native_available() and ballsim.build_error is None


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


def test_slice5_entry_points_need_a_device_without_cuda(tmp_path):
    """With no CUDA device, the MotionVAE trainer, the library and pool
    loaders and the constructors that once defaulted to the CPU raise unless
    given device="cpu"; `load_stage_checkpoint` follows its learner's
    device and `random_walk_rollout` its spec's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.data.amass import build_motion_lib
    from vid2player3d_torch.data.motion_lib import MotionLib
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset
    from vid2player3d_torch.mvae.eval import random_walk_rollout
    from vid2player3d_torch.physics.asset import build_humanoid_model

    opt = MVAEOption(latent_size=4, hidden_size=8, num_experts=2, nframes_seq=4, batch_size=2,
                     checkpoint_dir=str(tmp_path))
    ds = make_synthetic_pose_dataset(opt, num_seqs=1, T=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MVAETrainer(opt, ds)
    trainer = MVAETrainer(opt, ds, device="cpu")
    assert trainer.model.encoder.fc1.weight.device.type == "cpu"
    spec = P.spec_from_trainer(trainer)
    root, _, _ = random_walk_rollout(spec, ds.raw_init_frames(2), num_steps=2)
    assert root.shape == (2, 2, 3)

    lib = make_synthetic_motion_lib(num_motions=1, T=30, device="cpu")
    lib.save(str(tmp_path / "lib.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionLib.load(str(tmp_path / "lib.npz"))
    assert MotionLib.load(str(tmp_path / "lib.npz"), device="cpu").device.type == "cpu"
    pool = TennisBallGenerator(num_candidates=64, device="cpu")
    pool.save_npz(str(tmp_path / "pool.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TennisBallGenerator.from_npz(str(tmp_path / "pool.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_humanoid_model(S.make_synthetic_smpl(), np.zeros((1, 10), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_motion_lib([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionLib.from_motions([])


def test_slice9_entry_points_need_a_device_without_cuda():
    """With no CUDA device, `ArticulationState.zeros` without `device`
    raises; `default_humanoid_state` follows its model's device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.physics.asset import build_humanoid_model, default_humanoid_state
    from vid2player3d_torch.physics.model import ArticulationState

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArticulationState.zeros(2, 24)
    assert ArticulationState.zeros(2, 24, device="cpu").root_pos.device.type == "cpu"
    model = build_humanoid_model(S.make_synthetic_smpl(), np.zeros((2, 10), np.float32),
                                 device="cpu")
    st = default_humanoid_state(model, 2)
    assert all(getattr(st, f).device == model.device for f in
               ("root_pos", "root_quat", "root_vel", "joint_quat", "joint_omega"))
    meta = build_humanoid_model(S.make_synthetic_smpl(), np.zeros((2, 10), np.float32),
                                device="meta")
    assert default_humanoid_state(meta, 2).root_quat.device.type == "meta"


def test_slice8_entry_points_need_a_device_without_cuda(tmp_path):
    """With no CUDA device, the data tools that return a MotionLib
    (`convert_amass_dir`, `tennis_motion_lib`) raise before any work unless
    given device="cpu"; the host-side tools (the FBX importer, the
    generator, the SMPL loaders) take no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.data.amass import convert_amass_dir
    from vid2player3d_torch.data.tennis_motion import tennis_motion_lib

    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_amass_dir(str(tmp_path), smpl_model=S.make_synthetic_smpl())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tennis_motion_lib(num_sequences=1)
    assert S.find_smpl_model(str(tmp_path)).num_verts == 384
    assert tennis_motion_lib(num_sequences=1, cycles_per_seq=1, device="cpu").num_motions == 1


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"use_context_ik": True},
                                {"minibatch_per_chip": True}, {"dp_sync": "per_mini_epoch"}],
                         ids=["mesh", "context_ik", "minibatch_per_chip", "dp_sync"])
def test_learner_unported_options_raise(kw):
    """Every learner option is ported; each builds and its invalid values
    raise. A mesh must be the port's `DataParallelMesh` (anything else raises
    TypeError), and one of a single rank builds on an unsharded env. The
    context IK builds the {ac, ctx} params (16 + 8 leaves). Per-chip
    minibatches build (at one rank the local batch is the batch) and a local
    batch the minibatch does not divide raises. Local SGD builds (at one rank
    it is the per-minibatch path) and an unknown sync mode raises."""
    from vid2player3d_torch.parallel import DataParallelMesh

    lib = make_synthetic_motion_lib(num_motions=1, T=30, device="cpu")
    env = HumanoidImEnv(HumanoidImConfig(num_envs=2), lib, device="cpu")
    cfg_kw = {k: v for k, v in kw.items() if k != "mesh"}
    if "mesh" in kw:
        with pytest.raises(TypeError):
            ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8), mesh=kw["mesh"],
                         device="cpu")
        one = DataParallelMesh(dp=1, rank=0, device=torch.device("cpu"))
        assert ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8), mesh=one).dp == 1
        return
    agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, **cfg_kw), device="cpu")
    if cfg_kw.get("use_context_ik"):
        names = list(agent.init_state().params)
        assert len(names) == 24 and sum(n.startswith("ctx.") for n in names) == 8
        with pytest.raises(TypeError):
            ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, **cfg_kw), mesh=object(),
                         device="cpu")
    elif "minibatch_per_chip" in cfg_kw:
        assert (agent.num_minibatches, agent.mb_local) == (1, 8)
        with pytest.raises(ValueError, match="local batch 8 not divisible"):
            ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=3, **cfg_kw), device="cpu")
    else:
        assert not agent.local_sgd and agent.num_minibatches == 1
        with pytest.raises(ValueError, match="dp_sync"):
            ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, dp_sync="never"),
                         device="cpu")


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


# -- the tennis slice ----------------------------------------------------------

def _tennis_env(num_envs=2, **kw):
    spec = P.make_random_spec(0, hidden=16, experts=2, device="cpu")
    feats = np.zeros((4, P.FRAME_SIZE), np.float32)
    feats[:, 2] = 0.95
    gen = TennisBallGenerator(num_candidates=64, seed=0, device="cpu")
    return spec, feats, gen, TennisEnv(TennisConfig(num_envs=num_envs, substeps=1, **kw), spec,
                                       feats, ball_generator=gen, device="cpu")


def test_tennis_entry_points_need_a_device_without_cuda():
    """With no CUDA device, the tennis entry points called without `device=`
    raise instead of running on the CPU: the MVAE spec, the ball pool, the
    frozen π_low, the env and the learner."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    spec, feats, gen, env = _tennis_env()
    for make in (lambda: P.make_random_spec(0, hidden=16, experts=2),
                 lambda: TennisBallGenerator(num_candidates=16),
                 lambda: FrozenImitator.zeros(),
                 lambda: TennisEnv(TennisConfig(num_envs=2), spec, feats, ball_generator=gen),
                 lambda: V2PPPO(env, V2PConfig(horizon=4, minibatch_size=8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert V2PPPO(env, V2PConfig(horizon=4, minibatch_size=8, actor_units=(8,),
                                 critic_units=(8,)), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,error", [({"num_policies": 0}, ValueError),
                                      ({"mesh": object()}, TypeError),
                                      ({"minibatch_per_chip": True}, ValueError)],
                         ids=["num_policies", "mesh", "minibatch_per_chip"])
def test_v2p_unported_options_raise(kw, error):
    """Every option of the tennis learner is ported, and its invalid values
    raise: fewer than one policy; a mesh that is not the port's
    `DataParallelMesh`; per-chip minibatches that do not divide the local
    batch (a dividing one builds). Lane-routed policies build stacked params."""
    _, _, _, env = _tennis_env()
    cfg_kw = {k: v for k, v in kw.items() if k != "mesh"}
    if "minibatch_per_chip" in cfg_kw:
        agent = V2PPPO(env, V2PConfig(horizon=4, minibatch_size=4, actor_units=(8,),
                                      critic_units=(8,), **cfg_kw), device="cpu")
        assert (agent.num_minibatches, agent.mb_local) == (2, 4)
        cfg_kw["minibatch_size"] = 3
    with pytest.raises(error):
        V2PPPO(env, V2PConfig(**{"horizon": 4, "minibatch_size": 8, **cfg_kw}),
               mesh=kw.get("mesh"), device="cpu")
    agent = V2PPPO(env, V2PConfig(horizon=4, minibatch_size=8, num_policies=2, actor_units=(8,),
                                  critic_units=(8,)), device="cpu")
    assert all(v.shape[0] == 2 for v in agent._initial_params().values())


def test_tennis_unported_options_raise():
    """The native ball backend builds a pool (on the host, then moved to the
    pool's device) and an unknown backend raises. Domain randomization is
    ported (an unknown target raises), and the two-hand backhand and one
    spec per lane build."""
    from vid2player3d_torch.envs.domain_rand import RandSpec

    spec, feats, gen, _ = _tennis_env()
    assert _tennis_env(rand_specs=(RandSpec("ball_base_cd", "uniform", (0.9, 1.1)),)
                       )[3].randomizer.ball_specs
    with pytest.raises(ValueError):
        _tennis_env(rand_specs=(RandSpec("ball_bogus"),))
    assert _tennis_env(two_hand_backhand=True)[3].any_two_hand
    TennisEnv(TennisConfig(num_envs=2), (spec, spec), feats, ball_generator=gen, device="cpu")
    nat = TennisBallGenerator(num_candidates=256, backend="native", device="cpu")
    assert nat.backend == "native" and nat.pool_size > 0 and nat.device.type == "cpu"
    with pytest.raises(ValueError):
        TennisBallGenerator(num_candidates=16, backend="jax", device="cpu")


def test_dual_entry_points_need_a_device_without_cuda():
    """With no CUDA device, `DualTennisEnv` and `V2PPPO(num_policies=2)`
    called without `device=` raise instead of running on the CPU; the dual
    env also raises on an odd env count and on candidate resets."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points default to it")
    spec, feats, gen, _ = _tennis_env()
    cfg = TennisConfig(num_envs=2, substeps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DualTennisEnv(cfg, (spec, spec), (feats, feats), ball_generator=gen)
    env = DualTennisEnv(cfg, (spec, spec), (feats, feats), ball_generator=gen, device="cpu")
    v2p = V2PConfig(horizon=4, minibatch_size=8, num_policies=2, actor_units=(8,),
                    critic_units=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V2PPPO(env, v2p)
    assert V2PPPO(env, v2p, device="cpu").device.type == "cpu"
    for bad in (TennisConfig(num_envs=3), TennisConfig(num_envs=4, reset_candidates=2)):
        with pytest.raises(ValueError):
            DualTennisEnv(bad, (spec, spec), (feats, feats), ball_generator=gen, device="cpu")


def test_k2_k3_wrappers_raise_on_cuda_tensor_without_card():
    """A CUDA tensor goes to the kernel: with no card (CUDA-typed fake
    tensors) the K2 and K3 wrappers raise and do not fall back to their plain
    versions; no launch is counted."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels would launch")
    before = (MOE.moe_linear.launches, FK.fk_chain.launches)
    with FakeTensorMode():
        x = torch.zeros(4, 8, device="cuda")
        coeff = torch.zeros(4, 3, device="cuda")
        w = torch.zeros(3, 8, 5, device="cuda")
        b = torch.zeros(3, 5, device="cuda")
        rot = torch.zeros(2, 24, 3, 3, device="cuda")
        off = torch.zeros(2, 24, 3, device="cuda")
        root = torch.zeros(2, 3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MOE.moe_linear(x, coeff, w, b)
    parents = tuple([-1] + list(range(23)))
    with pytest.raises(RuntimeError, match="CUDA"):
        FK.fk_chain(rot, off, root, parents)
    assert (MOE.moe_linear.launches, FK.fk_chain.launches) == before


def test_k2_k3_wrappers_plain_on_cpu_and_checks():
    """CPU tensors take the plain versions (no launch counted); bad dtypes,
    shapes, layouts and devices raise."""
    before = (MOE.moe_linear.launches, FK.fk_chain.launches)
    x, coeff = torch.ones(4, 8), torch.full((4, 3), 1.0 / 3.0)
    w, b = torch.ones(3, 8, 5), torch.ones(3, 5)
    torch.testing.assert_close(MOE.moe_linear(x, coeff, w, b), torch.full((4, 5), 9.0))
    with pytest.raises(TypeError):
        MOE.moe_linear(x.double(), coeff, w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(x, coeff[:, :2], w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(torch.ones(8, 4).t(), coeff, w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(x, coeff, w, b.to("meta"))
    chain = tuple([-1] + list(range(23)))
    rot = torch.eye(3).expand(2, 24, 3, 3).contiguous()
    off = torch.zeros(2, 24, 3)
    off[:, 1:, 0] = 1.0
    pos, rm = FK.fk_chain(rot, off, torch.zeros(2, 3), chain)
    torch.testing.assert_close(pos[:, :, 0], torch.arange(24.0).expand(2, 24))
    torch.testing.assert_close(rm, rot)
    with pytest.raises(ValueError):
        FK.fk_chain(rot, off[:, :23], torch.zeros(2, 3), chain)
    with pytest.raises(TypeError):
        FK.fk_chain(rot.double(), off, torch.zeros(2, 3), chain)
    assert (MOE.moe_linear.launches, FK.fk_chain.launches) == before
