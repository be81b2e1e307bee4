"""Parity of the port's PPO pieces with the JAX learner at full ImitatorNet
width (actor and critic 734→1024→1024→512, 75 actions, 4,693,068 params):
`_forward`, GAE, `_loss` (value, stats and gradients) on one fixed batch, and
optimizer steps on the optax-chain path and on the fused path (the port's K1
wrapper runs its plain version on the CPU; the JAX package runs its Pallas
kernel in interpret mode), with f32 and with bf16 moments.

Inputs are made from a seed with numpy and handed to both packages; params
are the JAX learner's init, copied through the checkpoint mapping. Both run
f32 on the CPU, the JAX side with highest-precision matmuls
(tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.learn import running_norm as JRN
from vid2player3d_tpu.learn.optim import scale_by_adam_lowmem
from vid2player3d_tpu.learn.ppo import diag_gaussian_neglogp as j_neglogp
from vid2player3d_tpu.ops.fused_adam import fused_clip_adam_apply as j_fused
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.learn import ImitationPPO, PPOConfig
from vid2player3d_torch.learn import running_norm as TRN
from vid2player3d_torch.learn.optim import clip_adam_apply, init_adam
from vid2player3d_torch.ops.fused_adam import fused_clip_adam_apply as t_fused
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

N_ENVS, HORIZON, MB = 4, 8, 16
B = 64           # loss batch
OBS_DIM = 734


def _quats(rng, *shape):
    q = rng.randn(*shape, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def agents():
    jenv = JEnv(JEnvCfg(num_envs=N_ENVS, substeps=2),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, JPPOCfg(horizon=HORIZON, minibatch_size=MB), seed=7)
    jparams = jagent.init_state().params
    tenv = HumanoidImEnv(HumanoidImConfig(num_envs=N_ENVS, substeps=2),
                         t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                         motion_ids=np.asarray(jenv.motion_ids), device="cpu")
    tagent = ImitationPPO(tenv, PPOConfig(horizon=HORIZON, minibatch_size=MB), seed=7,
                          device="cpu")
    tparams = tagent.init_state(CK.params_from_jax(_flatten(jparams))).params

    rng = np.random.RandomState(0)
    mean = (rng.randn(OBS_DIM) * 0.5).astype(np.float32)
    var = (rng.rand(OBS_DIM) + 0.1).astype(np.float32)
    jnorm = JRN.RunningNormState(n=jnp.float32(50.0), mean=jnp.asarray(mean),
                                 var=jnp.asarray(var))
    tnorm = TRN.RunningNormState(n=torch.tensor(50.0), mean=torch.tensor(mean),
                                 var=torch.tensor(var))
    return jagent, jparams, jnorm, tagent, tparams, tnorm


def test_full_width_params_copied(agents):
    """16 leaves, 4,693,068 params, heads small-init; the port's network
    holds exactly the JAX init after the checkpoint mapping."""
    _, jparams, _, tagent, tparams, _ = agents
    assert len(tparams) == 16
    assert sum(p.numel() for p in tparams.values()) == 4_693_068
    assert tparams["actor_mlp.0.weight"].shape == (1024, OBS_DIM)
    assert tparams["mu.weight"].shape == (75, 512)
    jflat = _flatten(jparams)
    np.testing.assert_array_equal(tparams["critic_mlp.2.weight"].detach().numpy(),
                                  jflat["params/critic_mlp/Dense_2/kernel"].T)
    # the port's own init follows the same distributions (lecun truncated
    # normal trunk, 0.01-scaled heads, zero biases)
    own = dict(tagent.net.named_parameters())
    for k, v in own.items():
        v, ref = v.detach(), tparams[k].detach()
        assert v.shape == ref.shape
        if k.endswith("bias"):
            assert float(v.abs().max()) == 0.0
        else:
            np.testing.assert_allclose(float(v.std()), float(ref.std()), rtol=0.05, err_msg=k)


def test_forward_matches(agents):
    """Imitation obs, normalized obs, mu (residual action included), value
    and context dofs from the same raw obs and context window. The obs are
    f32 rotation math (1e-5); mu and value go through three 1024-wide f32
    layers, summed in another order by the two frameworks (2e-5)."""
    jagent, jparams, jnorm, tagent, tparams, tnorm = agents
    rng = np.random.RandomState(1)
    n = 6
    raw = np.concatenate([rng.randn(n, 72) * 0.5, _quats(rng, n, 24).reshape(n, 96),
                          rng.randn(n, 69) * 0.3, rng.randn(n, 69), rng.randn(n, 72),
                          rng.randn(n, 72), rng.randn(n, 11) * 0.5], -1).astype(np.float32)
    L = 32 + 2 * 8
    ctx = np.concatenate([rng.randn(n, L, 72) * 0.5, _quats(rng, n, L, 24).reshape(n, L, 96),
                          rng.randn(n, L, 69) * 0.3, rng.randn(n, L, 72),
                          rng.randn(n, L, 69)], -1).astype(np.float32)
    t = 3
    jout = jagent._forward(jagent.env, jparams, jnorm, jnp.asarray(raw), jnp.asarray(ctx), t)
    with torch.no_grad():
        tout = tagent._forward(tparams, tnorm, torch.tensor(raw), torch.tensor(ctx), t)
    for name, x, y, atol in zip(("io", "io_n", "mu", "value", "c_dof"), jout, tout,
                                (1e-5, 1e-5, 2e-5, 2e-5, 0.0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=atol, rtol=1e-5, err_msg=name)


def test_gae_matches(agents):
    """GAE over a (T, N) trajectory with mid-horizon dones; f32 rounding."""
    jagent, _, _, tagent, _, _ = agents
    rng = np.random.RandomState(2)
    traj = {"reward": rng.rand(HORIZON, 5), "value": rng.randn(HORIZON, 5),
            "next_value": rng.randn(HORIZON, 5),
            "done": (rng.rand(HORIZON, 5) < 0.2).astype(np.float32)}
    traj = {k: v.astype(np.float32) for k, v in traj.items()}
    ja = jagent._gae({k: jnp.asarray(v) for k, v in traj.items()})
    ta = tagent._gae({k: torch.tensor(v) for k, v in traj.items()})
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)


@pytest.fixture(scope="module")
def loss_case(agents):
    """One minibatch whose old policy sits near the current one, so the PPO
    ratio spans both sides of the clip."""
    jagent, jparams, jnorm, tagent, tparams, tnorm = agents
    rng = np.random.RandomState(3)
    obs = (rng.randn(B, OBS_DIM) * 1.5).astype(np.float32)
    ctx_dof = (rng.randn(B, 69) * 0.3).astype(np.float32)
    mu_raw, _ = jagent.net.apply(jparams, JRN.normalize(jnorm, jnp.asarray(obs), 5.0))
    mu = np.asarray(mu_raw).copy()
    mu[:, :69] += ctx_dof
    sigma = np.asarray(jagent.sigma)
    old_mu = (mu + rng.randn(B, 75) * 0.02).astype(np.float32)
    action = (old_mu + sigma * rng.randn(B, 75)).astype(np.float32)
    old_neglogp = np.asarray(j_neglogp(jnp.asarray(action), jnp.asarray(old_mu), sigma[None]))
    batch = dict(obs=obs, action=action, old_mu=old_mu,
                 old_neglogp=old_neglogp.astype(np.float32),
                 adv=rng.randn(B).astype(np.float32),
                 return_norm=rng.randn(B).astype(np.float32),
                 alive=(rng.rand(B) > 0.2).astype(np.float32), ctx_dof=ctx_dof)
    (jloss, jstats), jgrads = jax.value_and_grad(jagent._loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jnorm, jagent.sigma)
    tloss, tstats = tagent._loss(tparams, {k: torch.tensor(v) for k, v in batch.items()},
                                 tnorm)
    names = list(tparams)
    tgrads = dict(zip(names, torch.autograd.grad(tloss, [tparams[k] for k in names])))
    return (float(jloss), {k: float(v) for k, v in jstats.items()},
            CK.params_from_jax(_flatten(jgrads)), float(tloss.detach()),
            {k: float(v) for k, v in tstats.items()}, tgrads)


def test_loss_and_stats_match(loss_case):
    """Loss and its stats; the clip fraction must be strictly between 0 and
    1 for the case to exercise both branches. The ratio is exp of a
    difference of two ~60-size neglogps (1e-5 of them), so 1e-4."""
    jloss, jstats, _, tloss, tstats, _ = loss_case
    assert 0.0 < jstats["clip_frac"] < 1.0
    assert set(tstats) == set(jstats)
    np.testing.assert_allclose(tloss, jloss, atol=1e-4, rtol=1e-5)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], atol=1e-4, rtol=1e-5, err_msg=k)


def test_loss_gradients_match(loss_case):
    """Gradients of all 16 leaves. Backprop through three 1024-wide f32
    layers sums in another order in each framework; each leaf is held to
    1e-4 of its own largest gradient, elementwise."""
    _, _, jgrads, _, _, tgrads = loss_case
    assert set(tgrads) == set(jgrads)
    for k, g in tgrads.items():
        ref = jgrads[k].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * scale, rtol=0, err_msg=k)


LR, MAX_NORM = 2e-5, 50.0
# global norms ~217 (clipped), ~22 (not clipped), ~108 (clipped)
GRAD_SCALES = (0.1, 0.01, 0.05)


@pytest.mark.parametrize("path", ["optax", "fused"])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_optimizer_steps_match(agents, path, moments):
    """Three optimizer steps at full width (clipped, unclipped, clipped) on
    the optax-chain path (optax `scale_by_adam` for f32 moments, the
    package's `scale_by_adam_lowmem` for bf16) and on the fused path (JAX
    Pallas in interpret mode against the port's K1 wrapper on CPU tensors).
    Tolerances are those of the JAX package's own fused-vs-optax test:
    params atol 3e-6 / rtol 1e-5, f32 moments atol 1e-6. bf16 moments are
    held to one bf16 ulp (2^-8) of the leaf's largest moment: the global
    norm over 4.7M gradients is summed in another order by each framework,
    so the clip scale can differ in its last bit, a moment at a bf16
    rounding boundary then rounds the other way, and the next step carries
    that ulp of the stored moment into an element whose new value may be
    far smaller (measured: at most 0.0021 of the leaf's largest moment, in
    a few dozen of 4.7M elements)."""
    _, jparams, _, _, tparams, _ = agents
    names = list(tparams)
    jflat = _flatten(jparams)
    # JAX leaves keyed by the port's names
    jtree = {k: jnp.asarray(v.numpy()) for k, v in CK.params_from_jax(jflat).items()}
    adam = optax.scale_by_adam(eps=1e-8) if moments == "f32" else scale_by_adam_lowmem(eps=1e-8)
    tx = optax.chain(optax.clip_by_global_norm(MAX_NORM), adam)
    jstate = tx.init(jtree)

    tp = [tparams[k].detach().clone() for k in names]
    tstate = init_adam(tp, torch.float32 if moments == "f32" else torch.bfloat16)
    rng = np.random.RandomState(4)
    for scale in GRAD_SCALES:
        g = {k: (rng.randn(*tparams[k].shape) * scale).astype(np.float32) for k in names}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = [torch.tensor(g[k]) for k in names]
        if path == "optax":
            up, jstate = tx.update(jg, jstate, jtree)
            jtree = optax.apply_updates(jtree, jax.tree_util.tree_map(lambda u: -LR * u, up))
            tstate = clip_adam_apply(tp, tstate, tg, torch.tensor(LR), MAX_NORM)
        else:
            jtree, adam_state = j_fused(jtree, jstate[1], jg, LR, MAX_NORM, interpret=True)
            jstate = (jstate[0], adam_state)
            count = t_fused(tp, tstate.mu, tstate.nu, tg, tstate.count, torch.tensor(LR),
                            MAX_NORM)
            tstate = type(tstate)(count=count, mu=tstate.mu, nu=tstate.nu)
    assert int(tstate.count) == int(jstate[1].count) == len(GRAD_SCALES)
    for i, k in enumerate(names):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jtree[k]), atol=3e-6, rtol=1e-5,
                                   err_msg=k)
        for tm, jm in ((tstate.mu[i], jstate[1].mu[k]), (tstate.nu[i], jstate[1].nu[k])):
            got, ref = tm.float().numpy(), np.asarray(jm, np.float32)
            if moments == "f32":
                np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=2.0 ** -8 * float(np.abs(ref).max()),
                                           err_msg=k)
