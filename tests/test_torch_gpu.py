"""The port's kernels (K1 fused clip+Adam: norm and multi-tensor update; K2
moe_linear: prep and 3xTF32 GEMM; K3 fk_chain) against their plain PyTorch
versions on the card; and the dual rally's step and two-hand IK on the card
against the same on the CPU, with K2's and K3's launches per dual step; the
epochs replayed from CUDA graphs (imitation, MotionVAE, tennis stage 1,
the two-hand single-player env, the dual rally, the context-IK and
domain-randomized configs) against their eager bodies, the launch counts
through replays, a replay with no host sync, a capture that fails; K1 in the
update graph under `fused_optimizer="auto"`.

Marked `gpu`: each test needs a CUDA device and skips without one (the check
is made inside the `cuda` fixture, never at import). This file imports no JAX,
so it also runs on a machine that has only the port's requirements:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import importlib

import pytest
import torch

from vid2player3d_torch.ops import fk as FK
from vid2player3d_torch.ops import fused_adam as FA

# the K2 module (the package binds the function `moe_linear` over its name)
MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' products in full f32, as the kernels compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# ragged sizes (one element, a head's bias, a size that is no multiple of the
# block) and the full-width trunk leaf
SIZES = (1, 69, 75 * 512, 1_000_003, 1024 * 734)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SIZES)
def test_k1_kernel_matches_plain(cuda, n, moments):
    """Three steps (clipped and not) on one leaf: the kernel does the plain
    version's f32 operations in the same order without FMA contraction, so
    params and moments agree to the last bit."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    p0 = torch.randn(n, generator=gen, device=cuda) * 0.05
    kern = [p0.clone(), torch.zeros(n, dtype=moments, device=cuda),
            torch.zeros(n, dtype=moments, device=cuda)]
    plain = [t.clone() for t in kern]
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    before = FA.leaf_update.launches
    for scale in (3.0, 0.01, 1.0):
        g = torch.randn(n, generator=gen, device=cuda) * scale
        scalars, count = FA.adam_scalars([g], count, 1e-3, 1.0)
        FA.leaf_update(*kern, g, scalars)
        FA._leaf_plain(*plain, g, scalars, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert FA.leaf_update.launches == before + 3
    for a, b in zip(kern, plain):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    assert not torch.equal(kern[0], p0)


def test_k1_apply_counts_one_launch_per_leaf(cuda):
    """`fused_clip_adam_apply` is two launches per optimizer step whatever
    the number of leaves (up to 64): one norm, one update; it keeps the count
    on the device."""
    shapes = ((1024, 734), (1024,), (75, 512), (75,))
    ps = [torch.zeros(s, device=cuda) for s in shapes]
    ms = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    vs = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    gs = [torch.ones_like(p) for p in ps]
    before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
    count = FA.fused_clip_adam_apply(ps, ms, vs, gs, torch.zeros((), dtype=torch.int32,
                                                                 device=cuda), 1e-3, 50.0)
    assert (FA.leaf_update.launches, FA.global_norm_scalars.launches) == \
        (before[0] + 1, before[1] + 1)
    assert count.device.type == "cuda" and int(count) == 1
    # clip scale 50/|g| < 1, first step: every param moves by -lr
    for p in ps:
        torch.testing.assert_close(p, torch.full_like(p, -1e-3), rtol=1e-5, atol=0.0)


def _multi_leaves(cuda, sizes, moments, offset=0, seed=0):
    """Leaves of `sizes`; with `offset`, each param is a slice at that
    element offset of a longer buffer, so its base is not 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ps = [(torch.randn(n + offset, generator=gen, device=cuda) * 0.05)[offset:] for n in sizes]
    ms = [torch.zeros(n, dtype=moments, device=cuda) for n in sizes]
    vs = [torch.zeros(n, dtype=moments, device=cuda) for n in sizes]
    return ps, ms, vs, gen


# ragged leaf sizes around the vector width and the 4096-element tile, one
# leaf of 1,000 tiles and one past it; a misaligned copy of the small ones;
# more leaves than the 64 a launch's table holds
MULTI = {"sizes": ((1, 75, 1023, 1024, 4_096_001), 0),
         "misaligned": ((1, 75, 1023, 1024, 4097), 1),
         "over_capacity": ((5,) * 70 + (3000,) * 10, 0)}


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(MULTI))
def test_k1_multi_tensor_matches_plain(cuda, case, moments):
    """Four steps of the multi-tensor update under the plain scalars, bit
    for bit with `_leaf_plain` per leaf; the norm kernel's scalars within
    1e-6 relative of `adam_scalars` and its count exact; one launch of each
    per 64 leaves."""
    sizes, offset = MULTI[case]
    pk, mk, vk, gen = _multi_leaves(cuda, sizes, moments, offset)
    pp, mp, vp = ([t.clone() for t in ts] for ts in (pk, mk, vk))
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    count_k = count.clone()
    lr = torch.tensor(1e-3, device=cuda)
    chunks = -(-len(sizes) // 64)
    before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
    for step in range(4):
        gs = [torch.randn(n, generator=gen, device=cuda) * (3.0 if step % 2 == 0 else 0.01)
              for n in sizes]
        scalars, count = FA.adam_scalars(gs, count, lr, 1.0)
        s_k, count_k = FA.global_norm_scalars(gs, count_k, lr, 1.0)
        torch.testing.assert_close(s_k, scalars, atol=0.0, rtol=1e-6)
        assert int(count_k) == int(count) == step + 1
        FA.update_leaves(pk, mk, vk, gs, scalars)
        for a in zip(pp, mp, vp, gs):
            FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert (FA.leaf_update.launches, FA.global_norm_scalars.launches) == \
        (before[0] + 4 * chunks, before[1] + 4 * chunks)
    for a, b in zip(pk + mk + vk, pp + mp + vp):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


def test_k1_norm_is_deterministic(cuda):
    """Ten norm passes over the same grads give the same scalars to the
    last bit: fixed partial slots summed in a fixed order, no float atomics."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    gs = [torch.randn(n, generator=gen, device=cuda) for n in (1, 75, 734 * 1024, 4_096_001)]
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    outs = [FA.global_norm_scalars(gs, count, 1e-3, 1.0)[0].clone() for _ in range(10)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=0.0, rtol=0.0)


def test_k1_rejects_what_it_does_not_take(cuda):
    p = torch.zeros(8, device=cuda)
    s = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        FA.leaf_update(p, torch.zeros(8, device=cuda), torch.zeros(8), torch.zeros(8, device=cuda),
                       s)
    with pytest.raises(TypeError):
        FA.leaf_update(p, *(torch.zeros(8, dtype=torch.float16, device=cuda),) * 2,
                       torch.zeros(8, device=cuda), s)


# -- K2 ---------------------------------------------------------------------

# the MVAE decoder's three layers at full width: (in, out) with E = 6
MOE_LAYERS = ((320, 256), (288, 256), (288, 290))


def _moe_inputs(dev, batch, d_in, d_out, experts=6, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, d_in, generator=gen, device=dev)
    coeff = torch.softmax(torch.randn(batch, experts, generator=gen, device=dev), -1)
    lim = (6.0 / d_in) ** 0.5            # he_uniform, as the decoder's init
    w = (torch.rand(experts, d_in, d_out, generator=gen, device=dev) * 2 - 1) * lim
    b = torch.randn(experts, d_out, generator=gen, device=dev) * 0.1
    return x, coeff, w, b


@pytest.mark.parametrize("layer", MOE_LAYERS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("batch", (1, 255, 7680, 10240))
def test_k2_kernel_matches_plain(cuda, batch, layer):
    """Kernel against the plain apply-then-blend version, one prep and one
    GEMM launch per call. Both sum ~2000 products per output (|out| ~ 3) in
    another order; the kernel's products are 3xTF32 (f32-grade) summed by the
    tensor cores: they agree to ~1e-5 of the sums' size, held to 1e-4."""
    x, coeff, w, b = _moe_inputs(cuda, batch, *layer)
    before = (MOE.moe_linear.launches, MOE.split_weights.launches)
    got = MOE.moe_linear(x, coeff, w, b)
    torch.cuda.synchronize()
    assert (MOE.moe_linear.launches, MOE.split_weights.launches) == \
        (before[0] + 1, before[1] + 1)
    want = MOE.moe_linear_ref(x, coeff, w, b)
    assert got.shape == (batch, layer[1])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# narrow widths: `in` no multiple of the 32-float K tile (37: nor of 4, so
# the wrapper pads x), `out` under one tile and one past it
NARROW = ((40, 24), (37, 130))


@pytest.mark.parametrize("layer", NARROW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k2_narrow_in_matches_plain(cuda, layer):
    """Per-expert K tiles that end inside a tile (TMA's zero fill) and a
    padded `in`, at B = 255, held to 1e-4 as the full-width layers."""
    x, coeff, w, b = _moe_inputs(cuda, 255, *layer, seed=3)
    got = MOE.moe_linear(x, coeff, w, b)
    want = MOE.moe_linear_ref(x, coeff, w, b)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("layer", MOE_LAYERS + NARROW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k2_prep_matches_plain(cuda, layer):
    """The prep kernel (TF32 split of W and the bias, transposed, padded) bit
    for bit with its plain version: `cvt.rna` and the emulated rounding
    agree."""
    _, _, w, b = _moe_inputs(cuda, 1, *layer, seed=4)
    before = MOE.split_weights.launches
    got = MOE.split_weights(w, b)
    assert MOE.split_weights.launches == before + 1
    want = MOE._split_plain(w, b, MOE.padded_in(layer[0], w.shape[0]))
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("layer", MOE_LAYERS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k2_backward_matches_autograd(cuda, layer):
    """The autograd.Function's backward (the plain `_moe_bwd`) against
    autograd of the plain forward at B = 256. dw and db sum over the batch
    (|dw| up to ~30): held to 1e-3 absolute, 1e-4 relative."""
    x, coeff, w, b = _moe_inputs(cuda, 256, *layer, seed=1)
    g = torch.randn(256, layer[1], generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    leaves_k = [t.clone().requires_grad_(True) for t in (x, coeff, w, b)]
    leaves_p = [t.clone().requires_grad_(True) for t in (x, coeff, w, b)]
    got = torch.autograd.grad(MOE.moe_linear(*leaves_k), leaves_k, g)
    want = torch.autograd.grad(MOE.moe_linear_ref(*leaves_p), leaves_p, g)
    for name, a, c in zip(("dx", "dcoeff", "dw", "db"), got, want):
        torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-4, msg=name)


def test_k2_rejects_what_it_does_not_take(cuda):
    x, coeff, w, b = _moe_inputs(cuda, 8, 16, 8)
    before = MOE.moe_linear.launches
    with pytest.raises(TypeError):
        MOE.moe_linear(x.double(), coeff, w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(x.t().contiguous().t(), coeff, w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(x, coeff[:, :3], w, b)
    with pytest.raises(ValueError):
        MOE.moe_linear(x, coeff, w, b.cpu())
    assert MOE.moe_linear.launches == before


# -- K3 ---------------------------------------------------------------------

def _fk_inputs(dev, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rot = torch.eye(3, device=dev).expand(n, 24, 3, 3) \
        + 0.05 * torch.randn(n, 24, 3, 3, generator=gen, device=dev)
    off = torch.randn(n, 24, 3, generator=gen, device=dev) * 0.1
    root = torch.randn(n, 3, generator=gen, device=dev)
    return rot.contiguous(), off, root


def _parents(tree):
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.physics.asset import mujoco_parents

    return tuple(int(p) for p in (mujoco_parents() if tree == "mujoco" else S.SMPL_PARENTS))


def _k3_check(rot, off, root, parents):
    """One launch, bit for bit with the plain SoA chain: both round each
    product and each sum alone, in the same order (the kernel is built with
    -fmad=false)."""
    before = FK.fk_chain.launches
    pos, rm = FK.fk_chain(rot, off, root, parents)
    torch.cuda.synchronize()
    assert FK.fk_chain.launches == before + 1
    want_pos, want_rm = FK._fk_plain(rot, off, root, parents)
    torch.testing.assert_close(pos, want_pos, atol=0.0, rtol=0.0)
    torch.testing.assert_close(rm, want_rm, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("tree", ("mujoco", "smpl"))
@pytest.mark.parametrize("n", (1, 255, 256, 257, 10239, 10240, 15360))
def test_k3_kernel_matches_plain(cuda, n, tree):
    """Kernel against the plain SoA chain, one launch per call at every N:
    one env per CTA (1 to 257), the tennis path's 10,240 and 15,360 (runs
    of 20 and 30 envs, ragged last chunks), and 10,239 (a ragged last run)."""
    _k3_check(*_fk_inputs(cuda, n), _parents(tree))


@pytest.mark.parametrize("floats", (1, 3))
@pytest.mark.parametrize("n", (257, 10240))
def test_k3_offset_views_match_plain(cuda, n, floats):
    """Inputs that are contiguous views `floats` words into longer buffers
    (base addresses 4 or 12 bytes past a 16-byte boundary) go in as they
    are, bit for bit with the plain version."""
    rot, off, root = _fk_inputs(cuda, n, seed=1)
    views = []
    for t in (rot, off, root):
        buf = torch.zeros(t.numel() + floats, device=cuda)
        view = buf[floats:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4 * floats
        views.append(view)
    _k3_check(*views, _parents("smpl"))


@pytest.mark.parametrize("joints", (1, 7, 24, 32))
def test_k3_any_tree_matches_plain(cuda, joints):
    """Random trees (parents[j] < j, few of them the previous joint) of 1, 7,
    24 and 32 joints at N = 1,001, all through the kernel's loop build: rows
    of no multiple of 16 bytes (4-byte copies), 24 joints in another tree
    than the built-in ones, the largest slabs."""
    gen = torch.Generator().manual_seed(joints)
    parents = (-1,) + tuple(int(torch.randint(0, j, (), generator=gen))
                            for j in range(1, joints))
    g = torch.Generator(device=cuda).manual_seed(joints)
    rot = torch.eye(3, device=cuda) + 0.3 * torch.randn(1001, joints, 3, 3, generator=g,
                                                        device=cuda)
    off = torch.randn(1001, joints, 3, generator=g, device=cuda)
    assert FK.kernel_tree(parents) == 0
    _k3_check(rot, off, torch.randn(1001, 3, generator=g, device=cuda), parents)


def test_k3_builds_of_the_humanoid_trees(cuda):
    """The MuJoCo-order tree (the tennis path's) takes the kernel's
    straight-line build; the SMPL-order tree and a chain of 24 joints take
    its loop."""
    assert FK.kernel_tree(_parents("mujoco")) == 1
    assert FK.kernel_tree(_parents("smpl")) == 0
    assert FK.kernel_tree((-1,) + tuple(range(23))) == 0


def test_k3_is_deterministic(cuda):
    """Ten calls on the same inputs agree to the last bit."""
    args = _fk_inputs(cuda, 10240, seed=2)
    parents = _parents("mujoco")
    outs = [FK.fk_chain(*args, parents) for _ in range(10)]
    for pos, rm in outs[1:]:
        torch.testing.assert_close(pos, outs[0][0], atol=0.0, rtol=0.0)
        torch.testing.assert_close(rm, outs[0][1], atol=0.0, rtol=0.0)


def test_k3_library_refuses_a_shape_it_does_not_lay_out(cuda):
    """The C entry checks the launch shape against its own layout: shared
    memory other than `launch_shape`'s, no env per CTA, or more than 32
    joints return cudaErrorInvalidValue (1) and launch nothing."""
    rot, off, root = _fk_inputs(cuda, 64)
    pos, rm = torch.empty_like(off), torch.empty_like(rot)
    fn = FK._kernel_fn()
    par = FK._parent_array(_parents("mujoco"))
    good = FK.launch_shape(64, 24)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ptrs = [t.data_ptr() for t in (rot, off, root, pos, rm)]
    for envs, smem, joints in ((good["envs_per_cta"], good["smem_bytes"] - 16, 24),
                               (0, good["smem_bytes"], 24),
                               (good["envs_per_cta"], good["smem_bytes"], 33)):
        assert fn(*ptrs, 64, joints, par, envs, smem, stream) == 1
    assert fn(*ptrs, 64, 24, par, good["envs_per_cta"], good["smem_bytes"], stream) == 0
    torch.cuda.synchronize()


def test_k3_rejects_what_it_does_not_take(cuda):
    rot, off, root = _fk_inputs(cuda, 4)
    parents = _parents("mujoco")
    before = FK.fk_chain.launches
    with pytest.raises(RuntimeError, match="gradient"):
        FK.fk_chain(rot.requires_grad_(True), off, root, parents)
    rot = rot.detach()
    with pytest.raises(TypeError):
        FK.fk_chain(rot.double(), off, root, parents)
    with pytest.raises(ValueError):
        FK.fk_chain(rot, off[:, :23], root, parents)
    with pytest.raises(ValueError):
        FK.fk_chain(rot, off, root, (-1,) + (5,) * 23)
    assert FK.fk_chain.launches == before


# -- the dual rally ---------------------------------------------------------------

def _dual_env(dev, n):
    """A small nadal_federer pairing on `dev` (the same seeded weights on
    every device): a left-handed two-hand lane and a right-handed one."""
    import dataclasses

    import numpy as np

    from vid2player3d_torch.envs import DualTennisEnv, TennisConfig
    from vid2player3d_torch.learn import FrozenImitator
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    specs = (dataclasses.replace(P.make_random_spec(0, player="nadal", hidden=32, experts=2,
                                                    device=dev), righthand=False),
             P.make_random_spec(1, player="federer", hidden=32, experts=2, device=dev))
    frames = []
    for seed in (0, 1):
        f = (np.random.default_rng(seed).standard_normal((8, P.FRAME_SIZE)) * 0.05
             ).astype(np.float32)
        f[:, 2] = 0.95
        frames.append(f)
    pool = TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    gen = TennisBallGenerator.from_arrays(pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                          pool.launch_vspin, device=dev)
    pi_low = [FrozenImitator(net=ImitatorNet(num_actions=75,
                                             generator=torch.Generator().manual_seed(s)).to(dev),
                             obs_norm=RN.RunningNormState.create(734, dev)) for s in (0, 1)]
    cfg = TennisConfig(num_envs=n, substeps=2, max_episode_length=40,
                       reward_type="return_w_estimate", ball_reaction_force=True,
                       ball_body_contact=True, reset_candidates=0)
    return DualTennisEnv(cfg, specs, frames, ball_generator=gen, pi_low=pi_low[0],
                         pi_low_b=pi_low[1], two_hand_lanes=(True, False), device=dev)


def _dual_draws(rng, n, pool):
    def reset():
        return {"init_idx": rng.integers(0, 8, n), "root_xy_u": rng.random((n, 2)),
                "ball_idx": rng.integers(0, pool, n), "target_u": rng.random((n, 3)),
                "tt": rng.integers(-5, 5, n), "serve_u": rng.random((n, 3))}

    return reset(), [dict(reset=reset(), rw_noise=rng.standard_normal((n, 32)),
                          target_u=rng.random((n, 3)), tt=rng.integers(-5, 5, n))
                     for _ in range(3)]


def test_dual_steps_match_cpu_and_launch_k2_k3(cuda):
    """A dual reset and three steps (8 envs; the left-handed lane's rows
    start in a backhand, so the two-hand fix applies) on the card against
    the same on the CPU with the same draws and actions: every discrete
    output exact, obs and rewards to 1e-3 (another order of float sums
    through the stiff physics; the CPU port holds the JAX package at 1e-4).
    Each dual step launches K2 6 times (a prep and a GEMM per layer, a
    decode per lane) of each kind and K3 twice (the full masked reset and
    the FK targets)."""
    import dataclasses

    import numpy as np

    n = 8
    outs = {}
    for dev in ("cpu", cuda):
        env = _dual_env(dev, n)
        rng = np.random.default_rng(0)
        reset, steps = _dual_draws(rng, n, env.gen.pool_size)
        state, _ = env.reset_all(reset)
        state = dataclasses.replace(state, mvae=dataclasses.replace(
            state.mvae, swing_type=torch.where(env.two_hand_mask, 2, state.mvae.swing_type
                                               ).to(torch.int32)))
        acts = rng.standard_normal((3, n, env.num_actions)).astype(np.float32) * 0.5
        got = []
        for k in range(3):
            before = (MOE.moe_linear.launches, MOE.split_weights.launches, FK.fk_chain.launches)
            with torch.no_grad():
                state, out = env.step(state, torch.tensor(acts[k], device=dev), steps[k])
            launched = (MOE.moe_linear.launches - before[0],
                        MOE.split_weights.launches - before[1], FK.fk_chain.launches - before[2])
            if torch.device(dev).type == "cuda":
                assert launched == (6, 6, 2), launched
            got.append({f: getattr(out, f).cpu().numpy() for f in
                        ("obs", "reward", "done", "terminate")})
        outs[str(dev)] = got
    for k, (a, b) in enumerate(zip(outs["cpu"], outs[str(cuda)])):
        for f in ("done", "terminate"):
            np.testing.assert_array_equal(b[f], a[f], err_msg=f"step {k} {f}")
        for f in ("obs", "reward"):
            np.testing.assert_allclose(b[f], a[f], atol=1e-3, err_msg=f"step {k} {f}")


def test_two_hand_ik_matches_cpu(cuda):
    """The two-hand IK (8 Adam steps) on 256 seeded poses on the card
    against the CPU: 1e-4."""
    import numpy as np

    from vid2player3d_torch.core import rot as R
    from vid2player3d_torch.tennis import twohand as TH

    rng = np.random.default_rng(1)
    aa = torch.tensor(rng.standard_normal((256, 24, 3)).astype(np.float32) * 0.4)
    rest = torch.tensor(np.cumsum(rng.standard_normal((256, 24, 3)) * 0.1, axis=1)
                        .astype(np.float32))
    rm = R.angle_axis_to_rotmat(aa)
    mask = torch.tensor(rng.random(256) < 0.5)
    want = TH.optimize_two_hand_backhand(rm, rest, righthand=False, iters=8, mask=mask)
    got = TH.optimize_two_hand_backhand(rm.to(cuda), rest.to(cuda), righthand=False, iters=8,
                                        mask=mask.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


# -- slice 4: domain randomization and the context IK ----------------------------

def _ik_inputs(b, seed=0):
    """Seeded moderate poses (the SMPL FK of random angle-axis), the rest
    pose and random twist / leaf residuals, on the CPU."""
    import numpy as np

    from vid2player3d_torch.core import rot as R
    from vid2player3d_torch.core import smpl as S

    rng = np.random.default_rng(seed)
    rest = S.rest_joints(S.make_synthetic_smpl(), torch.zeros(b, 10))
    aa = torch.tensor(rng.uniform(-0.4, 0.4, (b, 24, 3)).astype(np.float32))
    posed, _ = S.batch_rigid_transform(R.angle_axis_to_rotmat(aa), rest)
    phis = torch.tensor(0.1 * rng.standard_normal((b, 46)).astype(np.float32))
    leaf = torch.tensor(0.1 * rng.standard_normal((b, 30)).astype(np.float32))
    return posed, rest, phis, leaf


@pytest.mark.parametrize("b", [512, 4096])
def test_context_ik_matches_cpu(cuda, b):
    """`perform_context_ik` at the minibatch (512) and rollout (4096) sizes
    on the card against the CPU: rotations and joints to 1e-4 (cuSOLVER's
    SVD against LAPACK's on distinct singular values), and the gradient into
    the twist and leaf residuals to 1e-4 of its scale."""
    from vid2player3d_torch.core import ik as IK

    outs = {}
    for dev in ("cpu", cuda):
        posed, rest, phis, leaf = (t.to(dev) for t in _ik_inputs(b))
        phis.requires_grad_(True)
        leaf.requires_grad_(True)
        local, chain, joints = IK.perform_context_ik(posed, rest, phis, leaf)
        loss = (local ** 2).sum() * 0.1 + (chain[..., 0] ** 3).sum() + joints.sum()
        grads = torch.autograd.grad(loss, (phis, leaf))
        outs[str(dev)] = [t.detach().cpu() for t in (local, chain, joints) + grads]
    for a, g in zip(outs["cpu"], outs[str(cuda)]):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, a, atol=1e-4 * max(1.0, float(a.abs().max())), rtol=0.0)


def _small_imitation(dev, preset_name, **ppo_kw):
    import dataclasses

    import numpy as np

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO

    env_cfg, ppo_cfg = preset(preset_name, num_envs=4, substeps=2)
    env = HumanoidImEnv(env_cfg, make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=dev),
                        motion_ids=np.array([0, 1, 1, 0]), device=dev)
    return ImitationPPO(env, dataclasses.replace(
        ppo_cfg, horizon=4, minibatch_size=8, mini_epochs=2, compute_dtype="f32",
        fused_optimizer="on", **ppo_kw), seed=7, device=dev)


def _imitation_draws(agent, rng):
    import numpy as np

    n, t, a = 4, 4, 75
    dr = agent.env.randomizer
    draws = {"motion_times": (rng.random(n) * 0.8).astype(np.float32),
             "noise": rng.standard_normal((t, n, a)).astype(np.float32),
             "perms": np.stack([rng.permutation(n * t) for _ in range(2)])}
    if dr is not None:
        draws["dr_model"] = [rng.random(n) for _ in dr.model_specs]
        draws["dr_act"] = [[rng.standard_normal((n, a)) for _ in dr.act_specs] for _ in range(t)]
        draws["dr_obs"] = [[rng.standard_normal((n, agent.env.obs_dim)) for _ in dr.obs_specs]
                           for _ in range(t)]
    if agent.env.cfg.transform_specs is not None:
        L = 48
        draws["corrupt"] = {"sel_u": rng.random((n, L, 24)),
                            "noise": rng.standard_normal((n, L, 24, 3)),
                            "drop_u": rng.random((n, L, 24))}
    return draws


@pytest.mark.parametrize("name", ["amass_im_dr", "amass_im_corrupt"])
def test_slice4_imitation_epoch_matches_cpu(cuda, name):
    """One small epoch (4 envs, f32, horizon 4, 2 mini-epochs) of a DR or a
    context-IK imitation learner on the card against the CPU with the same
    draws (the DR epoch from epoch 300, where the noise is on): every metric
    within the parity bounds of `chip_smoke.py`; K1 launches one norm and
    one update per optimizer step (16 or 24 leaves)."""
    import numpy as np

    metrics = {}
    for dev in ("cpu", cuda):
        agent = _small_imitation(dev, name)
        ts = agent.init_state()
        ts.epoch = 300 if name == "amass_im_dr" else 0
        draws = _imitation_draws(agent, np.random.default_rng(0))
        before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
        _, m = agent.train_epoch(ts, draws=draws)
        if torch.device(dev).type == "cuda":
            assert (FA.leaf_update.launches - before[0],
                    FA.global_norm_scalars.launches - before[1]) == (4, 4)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
    atol = {"a_loss": 1e-4, "c_loss": 1e-3, "b_loss": 1e-4, "kl": 1e-5, "clip_frac": 1e-6,
            "lr": 0.0}
    ref, got = metrics["cpu"], metrics[str(cuda)]
    for k in ref:
        assert abs(got[k] - ref[k]) <= atol.get(k, 1e-5) + 1e-4 * abs(ref[k]), k


def _mvae_trainer(device, tmp, seed=0):
    from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset

    opt = MVAEOption(latent_size=8, hidden_size=64, num_experts=3, nframes_seq=6, batch_size=8,
                     predict_phase=True, curriculum_schedule=(0.0, 0.25),
                     mixed_phase_schedule=((0.0, 1.0), (0.5, 0.1)), softmax_future=True,
                     n_epochs=4, n_epochs_decay=4, lr=3e-4, checkpoint_dir=str(tmp), seed=seed)
    ds = make_synthetic_pose_dataset(opt, num_seqs=3, T=60, seed=0)
    return MVAETrainer(opt, ds, device=device)


def test_mvae_epochs_match_cpu_and_launch_k2(cuda, tmp_path):
    """Two small MVAE epochs (2 windows of 5 optimizer steps each) on the
    card against the same on the CPU with the same draws: losses within
    1e-5 relative, params within 2·steps·lr and the update within 1e-3 of
    its norm (the CPU test's bounds against the JAX trainer); 3 prep + 3
    GEMM launches per optimizer step."""
    import numpy as np

    gpu, cpu = _mvae_trainer(cuda, tmp_path / "gpu"), _mvae_trainer("cpu", tmp_path / "cpu")
    p0 = [p.detach().cpu().clone() for p in cpu.params]
    rng = np.random.default_rng(1)
    steps = 0
    MOE.moe_linear.launches = MOE.split_weights.launches = 0
    for _ in range(2):
        eps = rng.standard_normal((2, 5, 8, 8)).astype(np.float32)
        lg = gpu.train_epoch(batches_per_epoch=2, draws={"eps": eps})
        lc = cpu.train_epoch(batches_per_epoch=2, draws={"eps": eps})
        steps += 10
        for k in lc:
            assert lg[k] == pytest.approx(lc[k], rel=1e-5, abs=1e-7), k
    torch.cuda.synchronize()
    assert MOE.moe_linear.launches == MOE.split_weights.launches == 3 * steps
    for a, b, b0 in zip(gpu.params, cpu.params, p0):
        a, b = a.detach().cpu(), b.detach()
        torch.testing.assert_close(a, b, atol=2 * steps * gpu.opt.lr, rtol=0)
        assert float((a - b).norm()) <= 1e-3 * float((b - b0).norm()) + 1e-12


# -- the epochs replayed from CUDA graphs (utils/graphs.py) --------------------

def _small_graphed_agent(cuda, fused):
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=cuda)
    env = HumanoidImEnv(HumanoidImConfig(num_envs=4, substeps=2), lib, device=cuda)
    return ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, mini_epochs=2,
                                       compute_dtype="f32", fused_optimizer=fused),
                        seed=7, device=cuda)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_graphed_epoch_equals_eager_on_the_card(cuda, fused):
    """`train_epoch` (graphed on the card) against `_train_epoch_eager` from
    two fresh states (one generator seed: the same draws), two epochs:
    params, moments, count, norms and metrics bit for bit at 4 envs; K1's
    launches 4 + 4 per epoch through the replays, one capture per graph."""
    agent = _small_graphed_agent(cuda, fused)
    assert agent.graphed
    a, b = agent.init_state(), agent.init_state()
    for _ in range(2):
        before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
        a, ma = agent.train_epoch(a)
        torch.cuda.synchronize()
        k1 = (FA.leaf_update.launches - before[0], FA.global_norm_scalars.launches - before[1])
        assert k1 == ((4, 4) if fused == "on" else (0, 0))
        b, mb = agent._train_epoch_eager(b)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        for k in a.params:
            torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
        for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert torch.equal(a.opt_state.count, b.opt_state.count)
        for f in ("n", "mean", "var"):
            assert torch.equal(getattr(a.obs_norm, f), getattr(b.obs_norm, f))
            assert torch.equal(getattr(a.val_norm, f), getattr(b.val_norm, f))
    assert agent._st.step.captures == agent._st.update.captures == 1
    assert agent._st.step.nodes > 1000 and agent._st.update.nodes > 100


def test_auto_takes_k1_in_the_update_graph_on_the_card(cuda, deterministic):
    """`fused_optimizer="auto"` on the card, at the card's compute dtype
    (bf16 trunks, bf16 moments): the learner takes K1; its update graph's
    capture records K1's norm and update once each, with fewer nodes than
    the optax chain's capture ("off"); two graphed epochs under "auto"
    equal the same epochs under "on" bit for bit (params, moments, count,
    metrics), with K1's launches 4 + 4 per epoch."""
    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
    from vid2player3d_torch.learn import ImitationPPO, PPOConfig

    lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device=cuda)
    runs = {}
    for fused in ("auto", "on", "off"):
        env = HumanoidImEnv(HumanoidImConfig(num_envs=4, substeps=2), lib, device=cuda)
        agent = ImitationPPO(env, PPOConfig(horizon=4, minibatch_size=8, mini_epochs=2,
                                            fused_optimizer=fused), seed=7, device=cuda)
        assert agent.graphed and agent.use_fused == (fused != "off")
        ts, rows, k1 = agent.init_state(), [], []
        for _ in range(2):
            before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
            ts, m = agent.train_epoch(ts)
            torch.cuda.synchronize()
            k1.append((FA.leaf_update.launches - before[0],
                       FA.global_norm_scalars.launches - before[1]))
            rows.append(m)
        assert agent._st.update.captures == 1
        runs[fused] = (agent, ts, rows, k1)
    auto, on, off = (runs[f][0]._st.update for f in ("auto", "on", "off"))
    assert auto.launches[:2] == on.launches[:2] == (1, 1) and off.launches[:2] == (0, 0)
    assert auto.nodes == on.nodes < off.nodes
    assert runs["auto"][3] == runs["on"][3] == [(4, 4)] * 2 and runs["off"][3] == [(0, 0)] * 2
    (_, a, ma, _), (_, b, mb, _) = runs["auto"], runs["on"]
    assert a.opt_state.mu[0].dtype == torch.bfloat16
    for x, y in zip(ma, mb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)
    assert int(a.opt_state.count) == int(b.opt_state.count) == 8


def test_graph_counters_advance_once_per_replay(cuda):
    """A step launching K1 (norm + update), K2 (prep + GEMM) and K3: the
    first call (the warm-up, then the capture) counts one launch of each,
    every replay one more, and the graph records the per-replay counts."""
    from vid2player3d_torch.utils.graphs import StaticGraph

    ps = [torch.zeros(1000, device=cuda), torch.zeros(75, device=cuda)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gs = [torch.full_like(p, 0.5) for p in ps]
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, coeff, w, b = (torch.randn(100, 32, generator=gen, device=cuda),
                      torch.softmax(torch.randn(100, 6, generator=gen, device=cuda), -1),
                      torch.randn(6, 32, 64, generator=gen, device=cuda),
                      torch.randn(6, 64, generator=gen, device=cuda))
    parents = (-1, 0, 1, 1, 3)
    rot = torch.eye(3, device=cuda).expand(8, 5, 3, 3).contiguous()
    off = torch.randn(8, 5, 3, generator=gen, device=cuda)
    root = torch.randn(8, 3, generator=gen, device=cuda)
    out = torch.zeros(100, 64, device=cuda)

    def body():
        count.copy_(FA.fused_clip_adam_apply(ps, ms, vs, gs, count, 1e-3, 50.0))
        out.copy_(MOE.moe_linear(x, coeff, w, b))
        FK.fk_chain(rot, off, root, parents)

    fns = (FA.leaf_update, FA.global_norm_scalars, MOE.split_weights, MOE.moe_linear,
           FK.fk_chain)
    before = [f.launches for f in fns]
    g = StaticGraph(body, cuda)
    for n in range(1, 5):
        g()
        torch.cuda.synchronize()
        assert [f.launches - b0 for f, b0 in zip(fns, before)] == [n] * 5
    assert g.launches == (1, 1, 1, 1, 1) and g.captures == 1
    assert int(count) == 4
    torch.testing.assert_close(out, MOE.moe_linear_ref(x, coeff, w, b), rtol=1e-4, atol=1e-4)


def test_capture_of_a_syncing_body_raises(cuda):
    """A body that reads a device value on the host runs once as the
    warm-up, then its capture raises; nothing runs it again eagerly, and no
    graph is kept."""
    from vid2player3d_torch.utils.graphs import StaticGraph

    x = torch.zeros(4, device=cuda)
    calls = []

    def body():
        calls.append(1)
        x.add_(1.0 + 0.0 * float(x.sum()))

    g = StaticGraph(body, cuda)
    with pytest.raises(Exception):
        g()
    torch.cuda.synchronize()
    assert len(calls) == 2 and g.graph is None
    assert torch.equal(x, torch.ones(4, device=cuda))


def test_capture_survives_graphs_left_to_the_collector(cuda):
    """A learner and its graphs form a reference cycle, freed only by the
    garbage collector; with the collector running at nearly every
    allocation, a graph dropped that way must not be freed while another
    captures (a freed pool inside a capture invalidates it)."""
    import gc

    from vid2player3d_torch.utils.graphs import StaticGraph

    class Owner:
        def step(self):
            self.x.mul_(0.5)

    def drop_a_graphed_owner():
        o = Owner()
        o.x = torch.ones(1 << 20, device=cuda)
        o.graph = StaticGraph(o.step, cuda)      # o -> graph -> bound method -> o
        o.graph()

    z = torch.zeros(8, device=cuda)

    def body():
        z.add_(1.0)
        for _ in range(2000):
            junk = Owner()
            junk.me = junk

    thresholds = gc.get_threshold()
    try:
        drop_a_graphed_owner()
        gc.set_threshold(1, 1, 1)
        g = StaticGraph(body, cuda)
        for _ in range(3):
            g()
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert g.captures == 1 and torch.equal(z, torch.full((8,), 3.0, device=cuda))


def _trace_alignment() -> dict:
    """A small graphed imitation epoch with the tracer off, then on (the
    graphs recaptured), then profiled: the graphs' node counts, the host
    syncs, and per replay how far its stamps, mapped onto the host clock by
    the epoch's anchors, lie outside the kineto interval of its kernels
    (the device events of its graph launch; negative: inside). Beside them
    how far kineto's own time of each anchor's stamp kernel lies outside
    the host times that bracket it, which holds kineto's clock itself."""
    from torch.profiler import ProfilerActivity, profile

    from vid2player3d_torch.utils import trace

    agent = _small_imitation(torch.device("cuda", 0), "amass_im")
    ts, _ = agent.train_epoch(agent.init_state())
    st = agent._st
    out = {"nodes_off": [st.step.nodes, st.update.nodes]}
    trace.tracer.enable(True)
    try:
        ts, _ = agent.train_epoch(ts)                 # captures anew, with the stamps
        out["nodes_on"] = [st.step.nodes, st.update.nodes]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ts, _ = agent.train_epoch(ts)
            torch.cuda.synchronize()
    finally:
        trace.tracer.enable(False)
    rec = trace.tracer.epochs[-1]
    out["host_syncs"] = trace.epoch_report(rec)["host_syncs"]
    replays = trace._replays(rec, trace._host_clock(rec))
    order = replays["step"] + replays["update"]        # the rollout's replays come first
    dev = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() != dev and e.name().startswith("cudaGraphLaunch"))
    kernels, stamps = {}, []
    for e in events:
        if e.device_type() == dev and not e.is_user_annotation():
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            lo, hi = kernels.get(e.correlation_id(), (s, t))
            kernels[e.correlation_id()] = (min(lo, s), max(hi, t))
            if "stamp_kernel" in e.name():
                stamps.append((s, t))
    out["replays"] = len(order)
    out["launches"] = len(launches)
    out["outside_ns"] = [max(max(kernels[corr][0] - s, e - kernels[corr][1]) for _, s, e, _ in row)
                         for (_, corr), row in zip(launches, order)]
    # each anchor's stamp kernel ran between the host reads around it
    out["anchor_outside_ns"] = [min(max(h0 - s, t - h1) for s, t in stamps)
                                for _, h0, h1 in rec["anchors"]]
    return out


def test_trace_stamps_lie_inside_their_replays_kernels(cuda):
    """The tracer's device stamps (``utils/trace.py``) on a small graphed
    imitation epoch (`_trace_alignment`, in a process of its own: in a
    process that ran the rest of this file kineto's device times drift from
    the host clock by ~0.1%, which its anchor stamps show): turning the
    tracer on recaptures both graphs with two stamp nodes per part, the
    traced epoch makes no host sync, and in one profiled traced epoch every
    stamp of a replay lies inside the kineto interval of that replay's
    kernels, widened by 20 µs."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json, sys; sys.path[:0] = ['.', 'tests']; import test_torch_gpu as T; "
            "print(json.dumps(T._trace_alignment()))")
    run = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    print(out)
    assert out["nodes_on"] == [n + 8 for n in out["nodes_off"]]
    assert out["host_syncs"] == 0
    assert out["launches"] == out["replays"] == 4 + 4          # horizon 4; 2 x 2 minibatches
    assert max(out["anchor_outside_ns"]) <= 20_000
    assert max(out["outside_ns"]) <= 20_000


def test_mvae_fuse_on_the_card(cuda, tmp_path):
    """`train_epoch(fuse=16)` and `fuse=1` (graphed windows) and the eager
    windows on one trainer seed each, 2 epochs of 5 windows: losses, params
    and count bit for bit; 3 prep + 3 GEMM launches per optimizer step
    through the replays."""
    runs = []
    for fuse in (16, 1, None):
        tr = _mvae_trainer(cuda, tmp_path / str(fuse))
        MOE.moe_linear.launches = MOE.split_weights.launches = 0
        losses = [tr.train_epoch(batches_per_epoch=5, fuse=fuse) if fuse else
                  tr._train_epoch_eager(5) for _ in range(2)]
        torch.cuda.synchronize()
        assert MOE.moe_linear.launches == MOE.split_weights.launches == 3 * 50
        runs.append((losses, [p.detach().clone() for p in tr.params], int(tr.opt_state.count)))
    for losses, params, count in runs[1:]:
        assert losses == runs[0][0] and count == runs[0][2] == 50
        for a, b in zip(params, runs[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tennis_learner(cuda, n, horizon, **env_kw):
    """A stage-1 learner on the card at test widths (the same seeded weights
    on every call): reach reward, discrete targets, 2 candidate resets,
    episodes of 6 steps; `env_kw` replaces env config fields."""
    import numpy as np

    from vid2player3d_torch.envs import TennisConfig, TennisEnv
    from vid2player3d_torch.learn import FrozenImitator, V2PConfig, V2PPPO
    from vid2player3d_torch.learn import running_norm as RN
    from vid2player3d_torch.learn.networks import ImitatorNet
    from vid2player3d_torch.tennis import player as P
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    frames = (np.random.default_rng(0).standard_normal((8, P.FRAME_SIZE)) * 0.05
              ).astype(np.float32)
    frames[:, 2] = 0.95
    pool = TennisBallGenerator(num_candidates=256, seed=0, device="cpu")
    gen = TennisBallGenerator.from_arrays(pool.traj_pool, pool.launch_pos, pool.launch_vel,
                                          pool.launch_vspin, device=cuda)
    pi_low = FrozenImitator(net=ImitatorNet(num_actions=75,
                                            generator=torch.Generator().manual_seed(0)).to(cuda),
                            obs_norm=RN.RunningNormState.create(734, cuda))
    env = TennisEnv(TennisConfig(**dict(dict(
                        num_envs=n, substeps=2, max_episode_length=6, reset_reaction_nframes=6,
                        reward_type="reach", use_random_ball_target="discrete",
                        reset_candidates=2), **env_kw)),
                    P.make_random_spec(0, hidden=32, experts=2, device=cuda), frames,
                    ball_generator=gen, pi_low=pi_low, device=cuda)
    return V2PPPO(env, V2PConfig(horizon=horizon, minibatch_size=16, mini_epochs=2,
                                 actor_units=(64, 32), critic_units=(64, 32),
                                 compute_dtype="f32"), seed=7, device=cuda)


@pytest.fixture
def deterministic():
    """`torch.use_deterministic_algorithms` for one test: the contact sums'
    `index_add` takes its sorted form, so two eager tennis epochs agree to
    the bit (with its atomics they differ in the last bits on the card)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _hold_graphed_to_eager(agent, T, per_step):
    """`agent.train_epoch` (graphed on the card) against `_train_epoch_eager`
    from one state and one seed of each generator, two epochs: metrics,
    params, moments, norms, env state and last obs bit for bit; K2 (prep,
    GEMM) and K3 launched `per_step` times per env step through the
    replays, as the eager epoch launches them; one capture per graph."""
    from vid2player3d_torch.parallel import mesh as PM

    assert agent.graphed
    env = agent.env
    g = env.generator.get_state()
    a = agent.init_state()
    env.generator.set_state(g)
    b = agent.init_state()
    for _ in range(2):
        g = env.generator.get_state()
        launched = []
        for graphed in (True, False):
            env.generator.set_state(g)
            before = (MOE.moe_linear.launches, MOE.split_weights.launches, FK.fk_chain.launches)
            if graphed:
                a, ma = agent.train_epoch(a)
            else:
                b, mb = agent._train_epoch_eager(b)
            torch.cuda.synchronize()
            launched.append((MOE.moe_linear.launches - before[0],
                             MOE.split_weights.launches - before[1],
                             FK.fk_chain.launches - before[2]))
        assert launched == [tuple(n * T for n in per_step)] * 2, launched
        for k in ma:
            assert torch.equal(ma[k], mb[k]) or bool(ma[k].isnan() & mb[k].isnan()), k
        for x, y in zip(PM.tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu, a.obs_norm,
                                        a.val_norm, a.env_state, a.last_obs)),
                        PM.tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu, b.obs_norm,
                                        b.val_norm, b.env_state, b.last_obs))):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert torch.equal(a.opt_state.count, b.opt_state.count)
    assert agent._st.step.captures == agent._st.update.captures == 1
    assert agent._st.step.launches[2:] == per_step


def test_graphed_tennis_epoch_equals_eager_on_the_card(cuda, deterministic):
    """The stage-1 learner's graphed epochs against its eager ones, two
    epochs at 8 envs under deterministic algorithms, bit for bit; K2 (3 prep
    + 3 GEMM) and K3 (2) per env step through the replays
    (`_hold_graphed_to_eager`)."""
    _hold_graphed_to_eager(_tennis_learner(cuda, 8, 4), 4, (3, 3, 2))


def test_graphed_two_hand_and_dual_epochs_equal_eager_on_the_card(cuda, deterministic):
    """The same for a single-player env with the two-hand backhand (the
    IK's autograd inside the step graph; K2 3 + 3 and K3 2 per step) and
    for the dual rally at 8 envs with two policies (the serve and hand-off
    flights; K2 6 + 6, one decode per lane, and K3 2 per step)."""
    from vid2player3d_torch.learn import V2PConfig, V2PPPO

    _hold_graphed_to_eager(_tennis_learner(cuda, 8, 4, two_hand_backhand=True,
                                           two_hand_iters=4), 4, (3, 3, 2))
    dual = V2PPPO(_dual_env(cuda, 8), V2PConfig(
        horizon=4, minibatch_size=16, mini_epochs=2, actor_units=(64, 32),
        critic_units=(64, 32), compute_dtype="f32", num_policies=2), seed=7, device=cuda)
    _hold_graphed_to_eager(dual, 4, (6, 6, 2))


def _ctx_dr_learner(cuda, name):
    """A small learner of amass_im_corrupt, amass_im_dr (4 envs, horizon 4,
    f32, fused K1) or federer_train_stage_1_dr (`_tennis_learner` at 4 envs
    under the config's randomization) on the card."""
    import dataclasses

    from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO

    env_cfg, ppo_cfg = preset(name, num_envs=4)
    if name == "federer_train_stage_1_dr":
        return _tennis_learner(cuda, 4, 4, rand_specs=env_cfg.rand_specs)
    env = HumanoidImEnv(dataclasses.replace(env_cfg, substeps=2), make_synthetic_motion_lib(
        num_motions=2, T=60, seed=0, device=cuda), device=cuda)
    return ImitationPPO(env, dataclasses.replace(ppo_cfg, horizon=4, minibatch_size=8,
                                                 mini_epochs=2, compute_dtype="f32",
                                                 fused_optimizer="on"), seed=7, device=cuda)


@pytest.mark.parametrize("name", ["amass_im_corrupt", "amass_im_dr", "federer_train_stage_1_dr"])
def test_ctx_dr_graphed_epoch_equals_eager_on_the_card(cuda, deterministic, name):
    """The context-IK and domain-randomized epochs replayed from graphs
    against their eager ones, two epochs at 4 envs under deterministic
    algorithms from epoch 300 (the linear noise on and growing, the model or
    ball constants drawn anew each epoch): metrics, params, moments, count
    and norms (and the tennis env state and last obs) bit for bit, one
    capture per graph; then one replayed step and one replayed update under
    `set_sync_debug_mode("error")`: no host sync."""
    from vid2player3d_torch.parallel import mesh as PM

    agent = _ctx_dr_learner(cuda, name)
    assert agent.graphed
    gen = getattr(agent.env, "generator", None)
    g = None if gen is None else gen.get_state()
    a = agent.init_state()
    if gen is not None:
        gen.set_state(g)
    b = agent.init_state()
    a.epoch = b.epoch = 300
    for _ in range(2):
        g = None if gen is None else gen.get_state()
        a, ma = agent.train_epoch(a)
        if gen is not None:
            gen.set_state(g)
        b, mb = agent._train_epoch_eager(b)
        for k in ma:
            assert torch.equal(ma[k], mb[k]) or bool(ma[k].isnan() & mb[k].isnan()), k
        fields = ("params", "opt_state", "obs_norm", "val_norm") + (
            ("env_state", "last_obs") if gen is not None else ())
        for f in fields:
            for x, y in zip(PM.tree_leaves(getattr(a, f)), PM.tree_leaves(getattr(b, f))):
                torch.testing.assert_close(x, y, rtol=0, atol=0, msg=f)
    st = agent._st
    assert st.step.captures == st.update.captures == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for graph in (st.step, st.update):
            st.row.zero_()
            graph(graph.key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert st.step.captures == st.update.captures == 1


def test_graphed_evaluation_equals_eager_on_the_card(cuda, deterministic):
    """The evaluation rollouts replayed from graphs (`eval.py`) against
    their eager bodies under deterministic algorithms, bit for bit:
    `eval_tennis`'s and `export_rollout`'s record sets on the stage-1
    learner at 8 envs and on the dual rally (two policies, a two-handed
    lane), K2 and K3 launched through the replays as the eager rollout
    launches them (per step 3 + 3 and 2; the dual 6 + 6 and 2), one capture
    per record set and a second call replaying; the MotionVAE random walk
    at 8 envs (K2 3 + 3 per step)."""
    import numpy as np

    from vid2player3d_torch import eval as E
    from vid2player3d_torch.learn import V2PConfig, V2PPPO
    from vid2player3d_torch.mvae import eval as ME
    from vid2player3d_torch.tennis import player as P

    def counts():
        return (MOE.moe_linear.launches, MOE.split_weights.launches, FK.fk_chain.launches)

    dual = V2PPPO(_dual_env(cuda, 8), V2PConfig(
        horizon=4, minibatch_size=16, mini_epochs=2, actor_units=(64, 32),
        critic_units=(64, 32), compute_dtype="f32", num_policies=2), seed=7, device=cuda)
    for agent, per_step in ((_tennis_learner(cuda, 8, 4), (3, 3, 2)), (dual, (6, 6, 2))):
        assert agent.graphed
        ts = agent.init_state()
        for record in (E._tennis_eval_record, E._tennis_export_record):
            launched, recs = [], []
            for roll in (E._tennis_rollout_eager, E._tennis_rollout, E._tennis_rollout):
                before = counts()
                recs.append(roll(agent, ts, 7, 6, None, record))
                torch.cuda.synchronize()
                launched.append(tuple(a - b for a, b in zip(counts(), before)))
            assert launched[0] == launched[1] == launched[2], launched
            for tar0, rec in ((r[1], r[2]) for r in recs[1:]):
                np.testing.assert_array_equal(tar0, recs[0][1])
                for k, v in recs[0][2].items():
                    np.testing.assert_array_equal(rec[k], v, err_msg=k)
            st = agent._eval_st[record]
            assert st.step.captures == 1 and st.step.launches[2:] == per_step
    spec = P.make_random_spec(0, hidden=32, experts=2, device=cuda)
    init = (np.random.default_rng(3).standard_normal((8, P.FRAME_SIZE)) * 0.05
            ).astype(np.float32)
    init[:, 2] = 0.95
    want = ME._random_walk_eager(spec, init, 10, 3, 1.0, None)
    before = counts()
    got = ME.random_walk_rollout(spec, init, 10, 3)
    assert tuple(a - b for a, b in zip(counts(), before)) == (30, 30, 0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_cli_curriculum_runs_on_the_card_by_default(cuda, tmp_path):
    """`cli.run.main` with no `--device` at test widths: mvae_federer (1
    epoch of 2 batches) -> federer_im (8 envs) -> federer_train_stage_1 (8
    envs, horizon 4), then its `--test --render`; each stage finds the last
    one's files, and the MotionVAE, stage-1 and eval calls launch K2 and K3
    (a wrapper counts only launches on CUDA tensors)."""
    import json
    import os

    from vid2player3d_torch.cli.run import main

    out = str(tmp_path)
    MOE.moe_linear.launches = FK.fk_chain.launches = 0
    assert main(["--cfg", "mvae_federer", "--epochs", "1", "--mvae_batches", "2",
                 "--out", out]) == 0
    assert MOE.moe_linear.launches > 0
    assert main(["--cfg", "federer_im", "--num_envs", "8", "--horizon", "4",
                 "--minibatch_size", "16", "--epochs", "1",
                 "--out", os.path.join(out, "federer_im")]) == 0
    MOE.moe_linear.launches = FK.fk_chain.launches = 0
    assert main(["--cfg", "federer_train_stage_1", "--num_envs", "8", "--horizon", "4",
                 "--minibatch_size", "16", "--epochs", "1", "--out", out]) == 0
    torch.cuda.synchronize()
    # the epoch's 4 steps (3 decodes' GEMMs and 2 FKs each) and the reset
    assert MOE.moe_linear.launches >= 12 and FK.fk_chain.launches >= 8
    row = json.loads(open(os.path.join(out, "metrics.jsonl")).readlines()[-1])
    assert row["grad_skip"] == 0.0
    html = os.path.join(out, "roll.html")
    assert main(["--cfg", "federer_train_stage_1", "--num_envs", "4", "--test", "--epochs", "1",
                 "--out", out, "--checkpoint", os.path.join(out, "best.npz"),
                 "--render", html]) == 0
    assert '"envs": [0, 1, 2, 3]' in open(html).read()


def test_native_pool_moves_to_the_card(cuda):
    """`TennisBallGenerator(backend="native")` with no device: flown on the
    host, the pool on the card; against the torch backend on the card, the
    candidates both keep carry identical launch states."""
    from vid2player3d_torch.tennis.ball import TennisBallGenerator

    nat = TennisBallGenerator(num_candidates=4096, seed=1, backend="native")
    tor = TennisBallGenerator(num_candidates=4096, seed=1, backend="torch")
    assert nat.device.type == "cuda" and nat.traj_pool.is_cuda and nat.x_order.is_cuda
    assert abs(nat.pool_size - tor.pool_size) <= 0.05 * tor.pool_size
    eq = (nat.launch_pos[:, None] == tor.launch_pos[None]).all(-1)     # (n_nat, n_tor)
    i, j = torch.nonzero(eq, as_tuple=True)
    assert i.numel() >= 0.95 * min(nat.pool_size, tor.pool_size)
    assert torch.equal(nat.launch_vel[i], tor.launch_vel[j])
    assert torch.equal(nat.launch_vspin[i], tor.launch_vspin[j])
    assert float((nat.traj_pool[i] - tor.traj_pool[j]).abs().max()) < 2e-2


@pytest.mark.parametrize("tool", ["convert_amass_dir", "tennis_motion_lib"])
def test_data_tools_build_libraries_on_the_card(cuda, tool, tmp_path):
    """`convert_amass_dir` (4 SMPLH clips of `chip_smoke.py`'s AMASS layout,
    one short clip and one broken file) and `tennis_motion_lib` (2 rallies)
    called without `device`: the library on the card, every field equal to
    the one built on the CPU within 1e-5 (the conversion runs on the host;
    only the upload and the card's arithmetic after it differ)."""
    import dataclasses

    import chip_smoke as CS
    from vid2player3d_torch.core import smpl as S
    from vid2player3d_torch.data import amass as AM
    from vid2player3d_torch.data import tennis_motion as TM

    if tool == "convert_amass_dir":
        d = str(tmp_path / "amass")
        CS.write_amass_fixture(d, n=4, T=240)
        lib = AM.convert_amass_dir(d, smpl_model=S.make_synthetic_smpl())
        ref = AM.convert_amass_dir(d, smpl_model=S.make_synthetic_smpl(), device="cpu")
        assert ref.num_motions == 4
    else:
        lib = TM.tennis_motion_lib(num_sequences=2)
        ref = TM.tennis_motion_lib(num_sequences=2, device="cpu")
    assert lib.device.type == "cuda"
    for f in dataclasses.fields(lib):
        a, b = getattr(lib, f.name), getattr(ref, f.name)
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, f.name
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0, msg=f.name)
