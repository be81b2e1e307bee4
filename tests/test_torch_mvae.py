"""The port's MVAE decode and its two kernels' plain versions against the
JAX package: K2 (`ops/moe_linear.py`) against `moe_linear_ref` and the Pallas
`_moe_kernel` in interpret mode, its backward against `_moe_bwd`; K3
(`ops/fk.py`) against `_fk_plain` and `_fk_pallas(interpret=True)`; and the
full-width `PoseMixtureVAE.sample` with the JAX params copied over.

All f32 on the CPU (where the port's wrappers take their plain versions),
inputs made with numpy from a seed.
"""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vid2player3d_tpu.core import smpl as JS
from vid2player3d_tpu.mvae.model import PoseMixtureVAE as JVAE
from vid2player3d_tpu.ops import fk as JFK
from vid2player3d_tpu.ops.moe_linear import _moe_bwd as j_moe_bwd
from vid2player3d_tpu.ops.moe_linear import _moe_kernel
from vid2player3d_tpu.ops.moe_linear import moe_linear_ref as j_moe_ref
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.mvae.config import MVAEOption
from vid2player3d_torch.mvae.model import PoseMixtureVAE
from vid2player3d_torch.ops import fk as FK
from vid2player3d_torch.physics.asset import mujoco_parents
from vid2player3d_torch.utils.checkpoint import mvae_params_from_jax

# the K2 module (the package binds the function `moe_linear` over its name)
MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

torch.set_num_threads(1)

B, D_IN, D_OUT, E = 64, 320, 256, 6     # the decoder's first layer at full width


@pytest.fixture(scope="module")
def moe_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, D_IN)).astype(np.float32)
    logits = rng.standard_normal((B, E))
    coeff = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    lim = np.sqrt(6.0 / (E * D_IN))
    w = rng.uniform(-lim, lim, (E, D_IN, D_OUT)).astype(np.float32)
    b = (rng.standard_normal((E, D_OUT)) * 0.1).astype(np.float32)
    return x, coeff, w, b


def _pallas_moe(x, coeff, w, b, tile_b=32):
    batch, d_in = x.shape
    experts, _, d_out = w.shape
    return pl.pallas_call(
        _moe_kernel, grid=(batch // tile_b,),
        in_specs=[pl.BlockSpec((tile_b, d_in), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((tile_b, experts), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((experts, d_in, d_out), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((experts, d_out), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tile_b, d_out), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((batch, d_out), x.dtype),
        scratch_shapes=[pltpu.VMEM((tile_b, d_out), jnp.float32)],
        interpret=True,
    )(x, coeff, w, b)


def test_k2_plain_matches_ref_and_pallas(moe_inputs):
    """The port's `moe_linear` on CPU tensors (its plain version, no launch
    counted) against the JAX `moe_linear_ref` and the Pallas kernel in
    interpret mode, at 1e-4 (the tolerance of tests/test_ops.py: f32 sums
    of 320 products in another order)."""
    x, coeff, w, b = moe_inputs
    before = MOE.moe_linear.launches
    got = MOE.moe_linear(*(torch.tensor(a) for a in moe_inputs)).numpy()
    assert MOE.moe_linear.launches == before
    want_ref = np.asarray(j_moe_ref(*(jnp.asarray(a) for a in moe_inputs)))
    want_kernel = np.asarray(_pallas_moe(*(jnp.asarray(a) for a in moe_inputs)))
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-4, atol=1e-4)


def test_k2_backward_matches_moe_bwd(moe_inputs):
    """The autograd.Function's backward against the JAX `_moe_bwd` and
    against torch autograd of the plain forward, at 1e-3 (tests/test_ops.py:
    dw and db sum over the batch)."""
    x, coeff, w, b = moe_inputs
    g = np.random.default_rng(1).standard_normal((B, D_OUT)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in moe_inputs]
    got = torch.autograd.grad(MOE.moe_linear(*leaves), leaves, torch.tensor(g))
    leaves_p = [torch.tensor(a, requires_grad=True) for a in moe_inputs]
    auto = torch.autograd.grad(MOE.moe_linear_ref(*leaves_p), leaves_p, torch.tensor(g))
    want = j_moe_bwd(32, tuple(jnp.asarray(a) for a in moe_inputs), jnp.asarray(g))
    for name, a, c, j in zip(("dx", "dcoeff", "dw", "db"), got, auto, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-3, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("tree", ["smpl", "mujoco"])
def test_k3_plain_matches_fk_plain_and_pallas(tree):
    """The port's `fk_chain` on CPU tensors against the JAX `_fk_plain` and
    `_fk_pallas(interpret=True)` at N = 512, atol 2e-5 (tests/test_ops.py)."""
    N = 512
    rng = np.random.default_rng(2)
    rm = (np.eye(3) + 0.05 * rng.standard_normal((N, 24, 3, 3))).astype(np.float32)
    off = (rng.standard_normal((N, 24, 3)) * 0.1).astype(np.float32)
    rp = rng.standard_normal((N, 3)).astype(np.float32)
    parents = tuple(int(p) for p in (JS.SMPL_PARENTS if tree == "smpl" else mujoco_parents()))

    before = FK.fk_chain.launches
    pos, rmat = FK.fk_chain(torch.tensor(rm), torch.tensor(off), torch.tensor(rp), parents)
    assert FK.fk_chain.launches == before
    p_pos, p_rm = JFK._fk_plain(jnp.asarray(rm), jnp.asarray(off), jnp.asarray(rp), parents)
    k_pos_t, k_rm_t = JFK._fk_pallas(
        jnp.transpose(rm, (1, 2, 3, 0)), jnp.transpose(off, (1, 2, 0)), jnp.transpose(rp),
        parents=parents, J=24, block=256, interpret=True)
    for want_pos, want_rm in ((p_pos, p_rm), (jnp.transpose(k_pos_t, (2, 0, 1)),
                                              jnp.transpose(k_rm_t, (3, 0, 1, 2)))):
        np.testing.assert_allclose(pos.numpy(), np.asarray(want_pos), atol=2e-5)
        np.testing.assert_allclose(rmat.numpy(), np.asarray(want_rm), atol=2e-5)


def test_k3_rejects_grad_and_bad_trees():
    """K3 has no gradient: an input that requires grad raises, as does a
    parent table that is not topologically ordered."""
    rot = torch.eye(3).expand(2, 24, 3, 3).contiguous()
    off, rp = torch.zeros(2, 24, 3), torch.zeros(2, 3)
    parents = tuple(int(p) for p in mujoco_parents())
    with pytest.raises(RuntimeError, match="gradient"):
        FK.fk_chain(rot.clone().requires_grad_(True), off, rp, parents)
    with pytest.raises(ValueError):
        FK.fk_chain(rot, off, rp, (-1,) + (3,) * 23)


def test_mvae_decode_full_width():
    """`PoseMixtureVAE.sample` at the federer MVAE's width (latent 32, hidden
    256, 6 experts, 288 -> 290) with the flax params copied by
    `mvae_params_from_jax`, on B = 8: three blended-expert layers and the
    gate in f32, held to 1e-4 (outputs ~1); and the encoder's (mu, logvar)
    on the same frames."""
    opt = MVAEOption.load("federer")
    F = opt.resolved_frame_size()
    assert (F, opt.hidden_size, opt.num_experts, opt.latent_size) == (288, 256, 6, 32)
    jvae = JVAE(frame_size_cond=F, frame_size_truth=F, frame_size_pred=F + 2,
                latent_size=opt.latent_size, hidden_size=opt.hidden_size,
                num_experts=opt.num_experts)
    key = jax.random.PRNGKey(0)
    params = jvae.init(key, jnp.zeros((1, F)), jnp.zeros((1, F)), key)["params"]
    rng = np.random.default_rng(3)
    z = rng.standard_normal((8, 32)).astype(np.float32)
    c = rng.standard_normal((8, F)).astype(np.float32)
    want = np.asarray(jvae.apply({"params": params}, jnp.asarray(z), jnp.asarray(c),
                                 method=JVAE.sample))

    tvae = PoseMixtureVAE(F, F, F + 2, latent_size=32, hidden_size=256, num_experts=6)
    state = mvae_params_from_jax(_flatten(params))
    assert set(state) == set(tvae.state_dict())
    tvae.load_state_dict(state)
    with torch.no_grad():
        got = tvae.sample(torch.tensor(z), torch.tensor(c)).numpy()
    assert got.shape == (8, F + 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    x = rng.standard_normal((8, F)).astype(np.float32)
    jmu, jlv = jvae.apply({"params": params}, jnp.asarray(x), jnp.asarray(c), method=JVAE.encode)
    with torch.no_grad():
        mu, lv = tvae.encode(torch.tensor(x), torch.tensor(c))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), rtol=1e-4, atol=1e-4)
