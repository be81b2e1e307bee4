"""The Hopper designs of K1, K2 and K3, checked on the CPU.

K1 (``ops/fused_adam.py``): the multi-tensor step (`fused_clip_adam_apply`,
`update_leaves`, `global_norm_scalars`) on CPU tensors against the per-leaf
plain version and against the JAX `fused_clip_adam_apply` with its Pallas
kernel in interpret mode; the host table that the card's two launches read.

K2 (``ops/moe_linear.py``): a torch emulation of the kernel's 3xTF32
arithmetic (round to TF32 as `cvt.rna` does, split each operand into a high
and a low part, sum lo*hi + hi*lo + hi*hi in f32) against the JAX
`moe_linear_ref` at the decoder's full-width layers: the split keeps
f32-grade results before any card run. And the tile choice that makes the
full-width grid one resident wave.

K3 (``ops/fk.py``): the launch shape (`launch_shape`) that the kernel's grid
and shared-memory layout follow: every (env, joint, row) owned by one lane,
the staged words on distinct shared-memory slots of the ring, the ring
inside an SM, the envs of a chunk spread over the banks, the grid balanced
over the SMs.

Inputs are made from a seed with numpy and handed to both packages.
"""

import importlib
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vid2player3d_tpu.learn.optim import scale_by_adam_lowmem
from vid2player3d_tpu.ops.fused_adam import fused_clip_adam_apply as j_fused
from vid2player3d_tpu.ops.moe_linear import moe_linear_ref as j_moe_ref
from vid2player3d_torch.ops import fk as FK
from vid2player3d_torch.ops import fused_adam as FA

# the K2 module (the package binds the function `moe_linear` over its name)
MOE = importlib.import_module("vid2player3d_torch.ops.moe_linear")

torch.set_num_threads(1)

# -- K1 ------------------------------------------------------------------------

# one element, a head's bias, one short of and exactly the TPU path's
# (8, 128) minimum tile, a trunk-like matrix, and a size no tile divides
LEAF_SHAPES = {"one": (1,), "bias": (75,), "short": (1023,), "tile": (8, 128),
               "trunk": (64, 96), "ragged": (4097,)}
LR, MAX_NORM = 2e-5, 50.0
GRAD_SCALES = (3.0, 0.05, 1.0)     # global norm ~ 225 (clipped), ~ 4, ~ 75 (clipped)


def _leaves(rng, mdt):
    params = {k: torch.tensor((rng.standard_normal(s) * 0.05).astype(np.float32))
              for k, s in LEAF_SHAPES.items()}
    mu = [torch.zeros(p.shape, dtype=mdt) for p in params.values()]
    nu = [torch.zeros(p.shape, dtype=mdt) for p in params.values()]
    return params, mu, nu


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_k1_multi_tensor_step_matches_per_leaf_and_jax(moments):
    """Three steps (clipped, not, clipped) of `fused_clip_adam_apply` over
    leaves the TPU path tiles and leaves it gives to plain jnp: bit for bit
    with `adam_scalars` + `_leaf_plain` per leaf, and against the JAX step
    (Pallas in interpret mode) at the tolerances of tests/test_torch_ppo.py
    (params atol 3e-6 / rtol 1e-5, f32 moments atol 1e-6, bf16 moments one
    bf16 ulp of the leaf's largest moment)."""
    mdt = torch.float32 if moments == "f32" else torch.bfloat16
    rng = np.random.default_rng(0)
    params, mu, nu = _leaves(rng, mdt)
    names = list(params)
    tp = [params[k].clone() for k in names]
    pp, mp, vp = [p.clone() for p in tp], [m.clone() for m in mu], [v.clone() for v in nu]
    jtree = {k: jnp.asarray(params[k].numpy()) for k in names}
    adam = optax.scale_by_adam(eps=1e-8) if moments == "f32" else scale_by_adam_lowmem(eps=1e-8)
    jstate = adam.init(jtree)
    count = torch.zeros((), dtype=torch.int32)
    count_p = count.clone()
    before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
    for scale in GRAD_SCALES:
        g = {k: (rng.standard_normal(LEAF_SHAPES[k]) * scale).astype(np.float32) for k in names}
        tg = [torch.tensor(g[k]) for k in names]
        count = FA.fused_clip_adam_apply(tp, mu, nu, tg, count, torch.tensor(LR), MAX_NORM)
        scalars, count_p = FA.adam_scalars(tg, count_p, torch.tensor(LR), MAX_NORM)
        for a in zip(pp, mp, vp, tg):
            FA._leaf_plain(*a, scalars, 0.9, 0.999, 1e-8)
        jtree, jstate = j_fused(jtree, jstate, {k: jnp.asarray(v) for k, v in g.items()}, LR,
                                MAX_NORM, interpret=True)
    assert (FA.leaf_update.launches, FA.global_norm_scalars.launches) == before
    assert int(count) == int(count_p) == int(jstate.count) == len(GRAD_SCALES)
    for i, k in enumerate(names):
        for a, b in ((tp[i], pp[i]), (mu[i], mp[i]), (nu[i], vp[i])):
            torch.testing.assert_close(a, b, atol=0.0, rtol=0.0, msg=k)
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jtree[k]), atol=3e-6, rtol=1e-5,
                                   err_msg=k)
        for tm, jm in ((mu[i], jstate.mu[k]), (nu[i], jstate.nu[k])):
            got, ref = tm.float().numpy(), np.asarray(jm, np.float32)
            atol = 1e-6 if moments == "f32" else 2.0 ** -8 * float(np.abs(ref).max())
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=k)


def test_k1_update_leaves_and_norm_cpu_are_the_plain_versions():
    """On CPU tensors `update_leaves` is `_leaf_plain` per leaf and
    `global_norm_scalars` is `adam_scalars`, bit for bit, with no launch
    counted; `leaf_update` is its one-leaf case."""
    rng = np.random.default_rng(1)
    params, mu, nu = _leaves(rng, torch.bfloat16)
    ps = list(params.values())
    grads = [torch.tensor(rng.standard_normal(p.shape).astype(np.float32)) for p in ps]
    before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
    count = torch.tensor(4, dtype=torch.int32)
    s_multi, c_multi = FA.global_norm_scalars(grads, count, 1e-3, 1.0)
    s_ref, c_ref = FA.adam_scalars(grads, count, 1e-3, 1.0)
    torch.testing.assert_close(s_multi, s_ref, atol=0.0, rtol=0.0)
    assert int(c_multi) == int(c_ref) == 5
    one = [[t.clone() for t in ts] for ts in (ps, mu, nu)]
    FA.update_leaves(ps, mu, nu, grads, s_ref)
    for p, m, v, g in zip(*one, grads):
        FA.leaf_update(p, m, v, g, s_ref)
    for a, b in zip(ps + mu + nu, one[0] + one[1] + one[2]):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    assert (FA.leaf_update.launches, FA.global_norm_scalars.launches) == before


def test_k1_host_table():
    """The table the card's launches read: rows [p, m, v, g, n] with the
    tensors' addresses, filled once per list of leaves and reused while the
    lists hold the same tensors; each step fills only the grads' column,
    making a strided grad contiguous, and rejects grads that do not fit."""
    ps = [torch.zeros(5), torch.zeros(3, 4)]
    ms = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    vs = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    table = FA._leaves(ps, ms, vs)
    assert table is FA._leaves(ps, ms, vs)
    assert table.moment_dtype == torch.bfloat16
    np.testing.assert_array_equal(table.rows[:, 0], [p.data_ptr() for p in ps])
    np.testing.assert_array_equal(table.rows[:, 2], [v.data_ptr() for v in vs])
    np.testing.assert_array_equal(table.rows[:, 4], [5, 12])
    grads = [torch.ones(5), torch.ones(4, 3).t()]
    held = table.with_grads(grads)
    assert held[0] is grads[0] and held[1].is_contiguous()
    np.testing.assert_array_equal(table.rows[:, 3], [g.data_ptr() for g in held])
    assert FA._leaves([ps[0], torch.zeros(3, 4)], ms, vs) is not table
    with pytest.raises(ValueError):
        table.with_grads([torch.ones(5)])
    with pytest.raises(ValueError):
        table.with_grads([torch.ones(5), torch.ones(11)])
    with pytest.raises(ValueError):
        table.with_grads([torch.ones(5), torch.ones(12, dtype=torch.float64)])
    with pytest.raises(TypeError):
        FA._Leaves(ps, [ms[0], vs[1].float()], vs)
    with pytest.raises(ValueError):
        FA._Leaves([ps[0], ps[1].t()], ms, vs)


def test_k1_multi_tensor_wrappers_raise_on_cuda_tensors_without_card():
    """CUDA tensors go to the kernels: with no card (CUDA-typed fake tensors)
    the multi-tensor entries raise instead of falling back to the plain
    versions, and count no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels would launch")
    with FakeTensorMode():
        ps = [torch.zeros(8, device="cuda")]
        ms = [torch.zeros(8, device="cuda")]
        vs = [torch.zeros(8, device="cuda")]
        gs = [torch.ones(8, device="cuda")]
        count = torch.zeros((), dtype=torch.int32, device="cuda")
        scalars = torch.ones(4, device="cuda")
    before = (FA.leaf_update.launches, FA.global_norm_scalars.launches)
    for call in (lambda: FA.update_leaves(ps, ms, vs, gs, scalars),
                 lambda: FA.global_norm_scalars(gs, count, 1e-3, 1.0),
                 lambda: FA.fused_clip_adam_apply(ps, ms, vs, gs, count, 1e-3, 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert (FA.leaf_update.launches, FA.global_norm_scalars.launches) == before


# -- K2 ------------------------------------------------------------------------

tf32_rna = MOE.tf32_rna


def moe_3xtf32(x, coeff, w, b, passes=3):
    """The kernels' arithmetic: W and bias split and transposed by the prep
    kernel's plain version; per expert, A = coeff[:, e] * x split into
    hi + lo, then lo*hi + hi*lo + hi*hi summed in f32 (`passes=1` keeps
    only hi*hi: single-pass TF32); last the bias tile, A = coeff against
    bias^T, split the same way."""
    w_hi, w_lo = MOE.split_weights(w, b)
    E, d_in4 = w.shape[0], w_hi.shape[2]
    out = torch.zeros(x.shape[0], w.shape[2])
    for e in range(E + 1):
        a = torch.zeros(x.shape[0], d_in4)
        if e < E:
            a[:, :x.shape[1]] = coeff[:, e:e + 1] * x
        else:
            a[:, :E] = coeff
        a_hi = tf32_rna(a)
        a_lo = tf32_rna(a - a_hi)
        if passes == 3:
            out = out + a_lo @ w_hi[e].T
            out = out + a_hi @ w_lo[e].T
        out = out + a_hi @ w_hi[e].T
    return out


def test_tf32_rna_emulation():
    """The prep kernel's plain rounding: ties away from zero, below-half
    down, above-half up, sign kept; the low 13 bits end up clear."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 2 ** -11 + 2 ** -20,
                      -(one + 2 ** -11), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one, one + 2 ** -10, -(one + 2 ** -10), 3.0, 0.0])
    torch.testing.assert_close(tf32_rna(x), want, atol=0.0, rtol=0.0)
    r = tf32_rna(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_k2_split_weights_plain():
    """The prep kernel's plain version: W (E, in, out) and bias (E, out) ->
    W_hi^T, W_lo^T (E + 1, out, in4), in4 = max(in, E) rounded up to 4, zero
    in the padding, bias^T in slot E; hi is TF32, lo is the TF32 rounding of
    the rest, and hi + lo is the weight to within 2^-22; no launch is
    counted."""
    gen = torch.Generator().manual_seed(0)
    w, b = torch.randn(3, 37, 20, generator=gen), torch.randn(3, 20, generator=gen)
    before = MOE.split_weights.launches
    hi, lo = MOE.split_weights(w, b)
    assert MOE.split_weights.launches == before
    assert hi.shape == lo.shape == (4, 20, 40)
    assert float(hi[:3, :, 37:].abs().sum()) == float(lo[:3, :, 37:].abs().sum()) == 0.0
    assert float(hi[3, :, 3:].abs().sum()) == float(lo[3, :, 3:].abs().sum()) == 0.0
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    torch.testing.assert_close(hi[:3, :, :37] + lo[:3, :, :37], w.transpose(1, 2),
                               atol=0.0, rtol=2.0 ** -22)
    torch.testing.assert_close(hi[3, :, :3] + lo[3, :, :3], b.T, atol=0.0, rtol=2.0 ** -22)
    torch.testing.assert_close(hi, tf32_rna(hi), atol=0.0, rtol=0.0)
    # more experts than inputs: the rows widen to hold the bias slot
    assert MOE.split_weights(torch.randn(6, 2, 5, generator=gen),
                             torch.randn(6, 5, generator=gen))[0].shape == (7, 5, 8)


# the decoder's three layers at full width, then narrow widths whose `in` is
# no multiple of the kernel's 32-float K tile (nor, for 37, of 4)
LAYERS = ((320, 256), (288, 256), (288, 290), (40, 24), (37, 130))


@pytest.mark.parametrize("layer", LAYERS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k2_3xtf32_emulation_matches_jax_ref(layer):
    """The 3xTF32 arithmetic against the JAX `moe_linear_ref` (f32, highest
    precision) at B = 256, E = 6, held to 1e-5 of max(1, |ref|); single-pass
    TF32 on the same inputs misses that tolerance, so the test can tell."""
    d_in, d_out = layer
    rng = np.random.default_rng(d_in * 1000 + d_out)
    x = rng.standard_normal((256, d_in)).astype(np.float32)
    logits = rng.standard_normal((256, 6))
    coeff = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    lim = np.sqrt(6.0 / (6 * d_in))
    w = rng.uniform(-lim, lim, (6, d_in, d_out)).astype(np.float32)
    b = (rng.standard_normal((6, d_out)) * 0.1).astype(np.float32)
    ref = np.asarray(j_moe_ref(*(jnp.asarray(a) for a in (x, coeff, w, b))))
    args = [torch.tensor(a) for a in (x, coeff, w, b)]
    tol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    err3 = float(np.abs(moe_3xtf32(*args).numpy() - ref).max())
    err1 = float(np.abs(moe_3xtf32(*args, passes=1).numpy() - ref).max())
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)


@pytest.mark.parametrize("layer", LAYERS[:3], ids=lambda s: f"{s[0]}x{s[1]}")
def test_k2_tiles_fill_one_wave(layer):
    """192 x BN tiles at B = 10,240: every full-width layer is 108 CTAs, one
    per SM in one resident wave on an H100's 132 SMs; the 290-wide layer takes
    BN = 152 (two column tiles, 5% padding) rather than three tiles of 128."""
    d_in, d_out = layer
    bn = MOE.tile_width(d_out)
    assert bn == (152 if d_out == 290 else 128)
    ctas = -(-10240 // 192) * -(-d_out // bn)
    assert ctas == 108 <= 132
    assert bn * -(-d_out // bn) <= 1.05 * d_out


def test_k2_prep_raises_on_cuda_tensor_without_card():
    """A CUDA tensor goes to the prep kernel: with no card (CUDA-typed fake
    tensors) `split_weights` raises instead of taking its plain version, and
    counts no launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    with FakeTensorMode():
        w = torch.zeros(3, 8, 5, device="cuda")
        b = torch.zeros(3, 5, device="cuda")
    before = MOE.split_weights.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        MOE.split_weights(w, b)
    assert MOE.split_weights.launches == before


# -- K3 ------------------------------------------------------------------------

SM_BYTES = 233_472       # shared memory of one H100 SM (228 KB)
CTA_BYTES = 232_448      # the most one CTA may use (227 KB)
CTA_RESERVED = 1024      # bytes the SM keeps per resident CTA


def _stage_words(length, stride, count, threads=FK.THREADS):
    """The kernel's `stage_in` / `stage_out` walk: 16-byte units where the
    row is a multiple of 4 floats (an aligned base), else 4-byte words;
    thread t takes units t, t + threads, ... of `count` rows, walking row e
    and offset q with one division up front. Returns the (word, slot) pairs
    of every float moved."""
    width = 4 if length % 4 == 0 else 1
    units = length // width
    pairs = []
    de, dq = divmod(threads, units)
    for t in range(threads):
        e, q = divmod(t, units)
        for f in range(t, units * count, threads):
            pairs += [(width * f + i, e * stride + width * q + i) for i in range(width)]
            e, q = e + de, q + dq
            if q >= units:
                e, q = e + 1, q - units
    return np.array(pairs).reshape(-1, 2)


@pytest.mark.parametrize("n", (1, 31, 32, 33, 255, 256, 10239, 10240, 15360))
def test_k3_launch_shape_covers_every_env_once(n):
    """CTA b owns envs [b * E, (b + 1) * E) and walks them in chunks of 8;
    lane t < 24 owns row t % 3 of env t // 3 of each chunk over all joints:
    every (env, row) of N envs has exactly one lane, the tail CTA and the
    ragged last chunk included, and no CTA is empty; the CTA fits an SM's
    shared memory."""
    s = FK.launch_shape(n, 24)
    E = s["envs_per_cta"]
    assert s["threads"] == FK.THREADS >= 3 * FK.CHUNK
    assert s["smem_bytes"] <= CTA_BYTES
    owned = np.zeros((n, 3), np.int64)
    lane = np.arange(s["threads"])
    env, row = lane // 3, lane % 3
    for b in range(s["ctas"]):
        count = min(E, n - b * E)
        assert count >= 1
        assert -(-count // FK.CHUNK) <= s["chunks_per_cta"]
        for c0 in range(0, count, FK.CHUNK):
            live = env < min(FK.CHUNK, count - c0)
            np.add.at(owned, (b * E + c0 + env[live], row[live]), 1)
    assert (owned == 1).all()


@pytest.mark.parametrize("joints", (1, 7, 24, 32))
def test_k3_staged_rows_fill_distinct_slots(joints):
    """The three ring stages (a chunk's rot, off and root rows each) and the
    two output slabs (rotmat, pos rows), for a full chunk and a ragged one:
    each float
    of a chunk's range lands on its own slot (row e, offset q; the strided
    walk of the kernel agrees with f // len, f % len even when the thread
    count exceeds a row), 16-byte units start on 16-byte slots, no two
    regions share a slot, and they end at the bytes `launch_shape` asks for,
    under 227 KB at J = 32."""
    s = FK.launch_shape(10240, joints)
    rows = [(9 * joints, FK.padded_row(9 * joints)), (3 * joints, FK.padded_row(3 * joints)),
            (3, 3)]
    regions = rows * FK.STAGES + rows[:2] * FK.OUT_SLOTS
    for count in (FK.CHUNK, FK.CHUNK - 5):
        slots, base = [], 0
        for length, stride in regions:
            assert stride >= length and (stride % 4 == 0 or length % 4)
            pairs = _stage_words(length, stride, count)
            order = np.argsort(pairs[:, 0])
            f, slot = pairs[order, 0], pairs[order, 1]
            np.testing.assert_array_equal(f, np.arange(length * count))
            np.testing.assert_array_equal(slot, (f // length) * stride + f % length)
            if length % 4 == 0:
                assert ((base + slot[::4]) % 4 == 0).all()
            slots.append(base + slot)
            base += FK.CHUNK * stride
        slots = np.concatenate(slots)
        assert len(np.unique(slots)) == len(slots) and slots.max() < base
        assert 4 * base == s["smem_bytes"] <= CTA_BYTES


def test_k3_rows_spread_a_warp_over_the_banks():
    """The padded rows (220 and 76 floats at J = 24) put the 8 envs of a
    chunk, all in the first warp, on 8 distinct bank groups: the three lanes
    of an env broadcast one word and no two envs conflict, where the natural
    216 and 72 would put two envs on each bank."""
    for length in (216, 72):
        envs = np.arange(FK.CHUNK)
        assert np.bincount(envs * FK.padded_row(length) % 32).max() == 1
        assert np.bincount(envs * length % 32).max() == 2


def test_k3_grid_fills_the_card():
    """Four CTAs per SM at the tennis path's N, each a run of envs: 512 CTAs
    of 20 envs at 10,240 (every one of the H100's 132 SMs busy, at most 80
    envs on one against a mean of 78, 3 chunks per CTA) and 512 of 30 at
    15,360; all resident at once (four fit an SM's shared memory); the
    candidate reset's N = 256 takes 256 CTAs of one env."""
    shape = FK.launch_shape(10240, 24)
    assert (shape["envs_per_cta"], shape["ctas"], shape["chunks_per_cta"]) == (20, 512, 3)
    assert FK.H100_SMS <= shape["ctas"] <= FK.CTAS_PER_SM * FK.H100_SMS
    assert FK.CTAS_PER_SM * shape["envs_per_cta"] <= -(-10240 // FK.H100_SMS) + FK.CTAS_PER_SM
    assert SM_BYTES // (shape["smem_bytes"] + CTA_RESERVED) >= FK.CTAS_PER_SM
    assert (FK.launch_shape(15360, 24)["envs_per_cta"], FK.launch_shape(15360, 24)["ctas"]) \
        == (30, 512)
    assert FK.launch_shape(256, 24)["ctas"] == 256
    assert FK.launch_shape(0, 24)["ctas"] == 0
