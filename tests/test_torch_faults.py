"""Three departures of the port from the JAX package, repaired, each with its
case:

- the port's configs have every field of their JAX counterparts, with equal
  defaults (`TennisConfig.ball_bounce_x_half` was missing);
- a checkpoint's raw 2-byte void leaves (bf16 bytes, as JAX checkpoints
  written before the bf16 → f32 save conversion hold them) load to their
  bf16 values exactly;
- with two policies each sample takes its lane's output by a one-hot sum, as
  the JAX learner's einsum: a non-finite output of the other policy makes
  the sample non-finite (0·inf), in the forward and in the epoch, whose
  guarded update then skips every step as JAX's does.

The lane case runs one JAX `V2PPPO(num_policies=2)` epoch (4 envs, horizon 2,
one minibatch; one jit compile) with policy 1's mu bias set to inf.

Three more departures from the JAX package's signatures, repaired, and one
held, each with its case:

- `V2PPPO.init_state(warm)` takes JAX's warm-start fields (`params`,
  `opt_state`, `obs_norm`, `val_norm`, `epoch`, `lr`) in JAX's place, and
  the checkpoint loaders go through it; `params=` and `reset_draws=` are
  keywords;
- `MVAETrainer.decode(params, z, cond)` takes the params first, as the JAX
  package's own test calls it (`tr.decode(tr.params, z, c)`);
- `fused_clip_adam_apply` keeps the port's layout (held: there is no optax
  state) and refuses a call in the JAX layout instead of binding the
  gradients to `nu`;
- the MotionVAE random walk keeps its graph for the next walk of the same
  shape (`mvae/eval.py` `_walk_statics`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tennis import _state_arrays
from test_torch_mvae_train import tiny
from test_torch_tennis_env import build_envs, make_shared, step_draws
from vid2player3d_tpu.envs.humanoid_im import HumanoidImConfig as JHumanoidImConfig
from vid2player3d_tpu.envs.tennis import TennisConfig as JTennisConfig
from vid2player3d_tpu.learn.ppo import PPOConfig as JPPOConfig
from vid2player3d_tpu.learn.v2p_ppo import V2PConfig as JV2PConfig
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.mvae import MVAEOption as JOpt
from vid2player3d_tpu.mvae import MVAETrainer as JTrainer
from vid2player3d_tpu.mvae import dataset as JD
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.envs import HumanoidImConfig, TennisConfig, TennisEnv
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import FrozenImitator, PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.learn.optim import AdamState
from vid2player3d_torch.learn.running_norm import RunningNormState
from vid2player3d_torch.mvae import MVAEOption, MVAETrainer
from vid2player3d_torch.mvae import dataset as TD
from vid2player3d_torch.mvae import eval as ME
from vid2player3d_torch.ops import fused_adam as FA
from vid2player3d_torch.parallel import mesh as PM
from vid2player3d_torch.tennis import player as P
from vid2player3d_torch.tennis.ball import TennisBallGenerator
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)


@pytest.mark.parametrize("port,ref", [(TennisConfig, JTennisConfig),
                                      (HumanoidImConfig, JHumanoidImConfig),
                                      (PPOConfig, JPPOConfig), (V2PConfig, JV2PConfig)],
                         ids=["TennisConfig", "HumanoidImConfig", "PPOConfig", "V2PConfig"])
def test_config_fields_match_jax(port, ref):
    """Every field of the JAX config, in the port's, with an equal default
    (so every named configuration of the JAX CLI can be expressed)."""
    want = {f.name: f.default for f in dataclasses.fields(ref)}
    got = {f.name: f.default for f in dataclasses.fields(port)}
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}


def _bf16_void(values):
    """float32 values as raw bf16 bytes in a 2-byte void array, and the
    values those bytes hold."""
    t = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.dtype("V2")), t.float().numpy()


def test_bf16_void_leaves_load_exactly(tmp_path):
    """Params, running-norm statistics and MVAE weights saved as raw bf16
    bytes load to the bf16 values, bit for bit; f32 leaves beside them are
    unchanged."""
    vals = [1.0, -2.5, 0.15625, 3.140625, 1e-3, -65280.0]
    kernel, kernel_f = _bf16_void(np.reshape(vals, (2, 3)))
    bias, bias_f = _bf16_void(vals[:3])
    mean, mean_f = _bf16_void(vals)
    w, w_f = _bf16_void(np.reshape(vals * 2, (2, 2, 3)))
    path = str(tmp_path / "bf16.npz")
    np.savez(path, **{"params/params/mu/kernel": kernel, "params/params/mu/bias": bias,
                      "obs_norm/0": np.float32(3.0), "obs_norm/1": mean,
                      "obs_norm/2": np.ones(6, np.float32), "decoder/moe0/w": w})
    flat = CK.load_npz(path)
    assert flat["params/params/mu/kernel"].dtype == np.dtype("V2")
    params = CK.params_from_jax(flat)
    np.testing.assert_array_equal(params["mu.weight"].numpy(), kernel_f.T)
    np.testing.assert_array_equal(params["mu.bias"].numpy(), bias_f)
    norm = CK.running_norm_from_jax(flat, "obs_norm")
    np.testing.assert_array_equal(norm.mean.numpy(), mean_f)
    assert float(norm.n) == 3.0 and norm.mean.dtype == torch.float32
    np.testing.assert_array_equal(CK.mvae_params_from_jax(flat)["decoder.moe0.w"].numpy(), w_f)


N, T, MB = 4, 2, 8
ENV = dict(num_envs=N, substeps=2, max_episode_length=40, reset_reaction_nframes=6,
           reward_type="reach", use_random_ball_target="discrete")
LEARNER = dict(horizon=T, minibatch_size=MB, mini_epochs=1, actor_units=(32, 16),
               critic_units=(32, 16), compute_dtype="f32", num_policies=2)


@pytest.fixture(scope="module")
def lanes():
    jenv, tenv = build_envs(make_shared(), **ENV)
    jagent = JV2P(jenv, JV2PConfig(**LEARNER), seed=5)
    jts0 = jagent.init_state()
    p = jax.tree_util.tree_map(np.array, jts0.params)
    p["params"]["mu"]["bias"][1] = np.inf
    jts0 = dataclasses.replace(jts0, params=jax.tree_util.tree_map(jnp.asarray, p))
    params = CK.params_from_jax(_flatten(jts0.params))
    env_state0, obs0 = _state_arrays(jts0.env_state), np.asarray(jts0.last_obs)
    jfwd = [np.asarray(x) for x in jagent._forward(jts0.params, jts0.obs_norm, jts0.last_obs)]

    _, k_roll, k_shuffle, _ = jax.random.split(jts0.key, 4)
    noise, env_draws = [], []
    key, env_key = k_roll, jts0.env_state.key
    for _ in range(T):
        key, k, _ = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k, (N, jenv.num_actions))))
        env_draws.append(step_draws(jenv, env_key))
        env_key = jax.random.split(env_key, 6)[0]
    perm = np.asarray(jax.vmap(lambda kk: jax.random.permutation(kk, N * T))(
        jax.random.split(jax.random.split(k_shuffle, 1)[0], 1)))
    draws = {"noise": np.stack(noise), "perms": perm, "env": env_draws}
    jts1, jm = jagent.train_epoch(jts0)

    tagent = V2PPPO(tenv, V2PConfig(**LEARNER), seed=5, device="cpu")
    tts0 = tagent.init_state(params=params)
    tts0.env_state = CK.tennis_state_from_jax(env_state0)
    tts0.last_obs = torch.tensor(obs0)
    with torch.no_grad():
        tfwd = [x.numpy() for x in tagent._forward(tts0.params, tts0.obs_norm, tts0.last_obs)]
    tts1, tm = tagent.train_epoch(tts0, draws=draws)
    return jfwd, tfwd, jm, tm, jts1, tts1, params


def test_other_lanes_inf_makes_the_sample_non_finite(lanes):
    """Policy 1's mu is inf on every row: the lane-0 rows come out NaN (0·inf)
    and the lane-1 rows inf, in the port exactly as in JAX; the value heads
    stay finite and equal."""
    jfwd, tfwd = lanes[:2]
    for j, t, name in zip(jfwd, tfwd, ("mu", "value")):
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=name)
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j), err_msg=name)
    assert np.isnan(tfwd[0][0::2]).all() and np.isinf(tfwd[0][1::2]).all()
    np.testing.assert_allclose(tfwd[1], jfwd[1], atol=1e-5)


def test_epoch_skips_every_update_as_jax(lanes):
    """The epoch's guarded update skips as JAX's does: the same `grad_skip`
    (every step), and the params (inf included) left as they were."""
    _, _, jm, tm, jts1, tts1, params = lanes
    assert float(tm["grad_skip"]) == float(jm["grad_skip"]) == 1.0
    jp = CK.params_from_jax(_flatten(jts1.params))
    for k, v in tts1.params.items():
        np.testing.assert_array_equal(v.detach().numpy(), params[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(jp[k].numpy(), params[k].numpy(), err_msg=k)
    assert int(tts1.opt_state.count) == 0


# -- the signatures of the JAX package ------------------------------------------

def _tennis_learner():
    """A stage-1 learner at test widths, the port's own pieces."""
    spec = P.make_random_spec(0, hidden=64, experts=3, device="cpu")
    feats = (np.random.default_rng(0).standard_normal((64, 288)) * 0.05).astype(np.float32)
    feats[:, 2] = 0.95
    env_cfg, v2p_cfg = preset("federer_train_stage_1", num_envs=4, reset_candidates=2)
    env = TennisEnv(env_cfg, spec, feats,
                    ball_generator=TennisBallGenerator(num_candidates=256, device="cpu"),
                    pi_low=FrozenImitator.zeros(device="cpu"), device="cpu")
    return V2PPPO(env, dataclasses.replace(v2p_cfg, horizon=4, minibatch_size=8,
                                           actor_units=(64, 32), critic_units=(64, 32),
                                           lr_schedule="adaptive"), device="cpu")


def test_v2p_init_state_takes_warm(tmp_path):
    """`init_state(warm=d)` with every JAX warm key gives, leaf for leaf, the
    state the stage warm start (`load_stage_checkpoint`) makes of the same
    values written to a file; each field is a copy of the warm one; a warm
    key JAX does not know, or params given twice, raise."""
    agent = _tennis_learner()
    g = torch.Generator().manual_seed(1)
    ts = agent.init_state()
    params = {k: v.detach() + 0.01 * torch.randn(v.shape, generator=g)
              for k, v in ts.params.items()}
    opt = AdamState(count=torch.tensor(7, dtype=torch.int32),
                    mu=[0.1 * torch.randn(v.shape, generator=g) for v in params.values()],
                    nu=[torch.rand(v.shape, generator=g) for v in params.values()])
    norms = [RunningNormState(n=torch.tensor(50.0), mean=torch.randn(d, generator=g),
                              var=torch.rand(d, generator=g)) for d in (agent.obs_dim, 1)]
    warm = dict(params=params, opt_state=opt, obs_norm=norms[0], val_norm=norms[1], epoch=12,
                lr=torch.tensor(3e-4))
    path = str(tmp_path / "stage.npz")
    src = dataclasses.replace(ts, params=params, opt_state=opt, obs_norm=norms[0],
                              val_norm=norms[1], epoch=12, lr=torch.tensor(3e-4))
    agent.save_checkpoint(path, src)

    gen = agent.env.generator.get_state()
    got = agent.init_state(warm=warm)
    agent.env.generator.set_state(gen)
    want = agent.load_stage_checkpoint(path)
    leaves = ("params", "opt_state", "obs_norm", "val_norm", "env_state", "last_obs", "lr")
    for f in leaves:
        for x, y in zip(PM.tree_leaves(getattr(got, f)), PM.tree_leaves(getattr(want, f))):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), f
    assert got.epoch == want.epoch == 12 and float(got.lr) == pytest.approx(3e-4)
    for k, v in got.params.items():
        assert torch.equal(v.detach(), params[k]) and v.requires_grad
        assert v.data_ptr() != params[k].data_ptr()
    assert got.opt_state.mu[0].data_ptr() != opt.mu[0].data_ptr()
    # the JAX learner's positional call, and the port's keywords
    assert torch.equal(agent.init_state(warm).params[next(iter(params))].detach(),
                       next(iter(params.values())))
    with pytest.raises(ValueError, match="params="):
        agent.init_state(params)
    with pytest.raises(ValueError, match="twice"):
        agent.init_state({"params": params}, params=params)


def test_mvae_decode_takes_params_first(tmp_path):
    """`MVAETrainer.decode(params, z, cond)` as the JAX package's test calls
    it (`tr.decode(tr.params, z, c)`), on the JAX trainer's initial weights:
    frame and phase agree to 1e-5. Params by name decode the same; zeroed
    params decode as the JAX trainer's zeroed ones, and the trainer's own
    weights stay as they were."""
    jopt, topt = tiny(JOpt, checkpoint_dir=str(tmp_path)), tiny(MVAEOption)
    jtr = JTrainer(jopt, JD.make_synthetic_pose_dataset(jopt, num_seqs=2, T=60, seed=1))
    ttr = MVAETrainer(topt, TD.make_synthetic_pose_dataset(topt, num_seqs=2, T=60, seed=1),
                      device="cpu")
    with torch.no_grad():
        ttr.model.load_state_dict(CK.mvae_params_from_jax(_flatten(jtr.params)))
    cond, _ = jtr.dataset.sample_first_frame()
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, jopt.latent_size)))
    c = np.tile(np.asarray(cond).reshape(1, -1), (5, 1)).astype(np.float32)
    want = jtr.decode(jtr.params, jnp.asarray(z), jnp.asarray(c))
    got = ttr.decode(ttr.params, torch.from_numpy(z), torch.from_numpy(c))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    by_name = ttr.decode(dict(ttr.model.named_parameters()), torch.from_numpy(z),
                         torch.from_numpy(c))
    for a, b in zip(by_name, got):
        assert torch.equal(a, b)
    zero = ttr.decode([torch.zeros_like(p) for p in ttr.params], torch.from_numpy(z),
                      torch.from_numpy(c))
    jzero = jtr.decode(jax.tree_util.tree_map(jnp.zeros_like, jtr.params), jnp.asarray(z),
                       jnp.asarray(c))
    for g, w in zip(zero, jzero):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert torch.equal(ttr.decode(ttr.params, torch.from_numpy(z), torch.from_numpy(c))[0],
                       got[0])
    with pytest.raises(ValueError, match="do not match"):
        ttr.decode({"w": torch.zeros(1)}, torch.from_numpy(z), torch.from_numpy(c))


def test_fused_adam_refuses_the_jax_layout():
    """The port's layout stays `(params, mu, nu, grads, count, lr, max_norm,
    b1, b2, eps)` (a held departure: no optax state); a call in the JAX
    layout `(params, opt_state, grads, lr, max_norm, b1, b2, eps,
    use_pallas, interpret)` raises a TypeError that names the port's layout
    and changes nothing, where it would otherwise bind the gradients to
    `nu` (and fail, if at all, deep inside on a float)."""
    import inspect

    assert list(inspect.signature(FA.fused_clip_adam_apply).parameters) == [
        "params", "mu", "nu", "grads", "count", "lr", "max_norm", "b1", "b2", "eps"]
    g = torch.Generator().manual_seed(0)
    ps = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn(p.shape, generator=g) for p in ps]
    opt = AdamState(count=torch.zeros((), dtype=torch.int32),
                    mu=[torch.zeros_like(p) for p in ps], nu=[torch.zeros_like(p) for p in ps])
    before = [p.clone() for p in ps]
    with pytest.raises(TypeError, match="missing"):      # too few for the port's layout
        FA.fused_clip_adam_apply(ps, opt, grads, 1e-3, 50.0)
    for call in ((ps, opt, grads, 1e-3, 50.0, 0.9, 0.999, 1e-8, False, False),
                 (ps, (opt.count, opt.mu, opt.nu), grads, 1e-3, 50.0, 0.9, 0.999, 1e-8)):
        with pytest.raises(TypeError, match=r"fused_clip_adam_apply\(params, mu, nu, grads"):
            FA.fused_clip_adam_apply(*call)
    for p, b in zip(ps, before):
        assert torch.equal(p, b)
    count = FA.fused_clip_adam_apply(ps, opt.mu, opt.nu, grads, opt.count, 1e-3, 50.0)
    assert int(count) == 1 and not torch.equal(ps[0], before[0])


def test_random_walk_keeps_its_graph():
    """Two walks of the same shape from two spec snapshots (one's weights
    changed in between): one capture in all, each walk's records equal to
    its eager walk's, bit for bit, and copies (the second walk leaves the
    first's records as they were). A new shape takes a new capture."""
    spec = P.make_random_spec(0, hidden=32, experts=3, device="cpu")
    init = (np.random.default_rng(0).standard_normal((4, 288)) * 0.05).astype(np.float32)
    init[:, 2] = 0.95
    ME._WALKS.clear()
    first = ME._random_walk_graphed(spec, init, 6, 3, 1.0, None)
    kept = [x.copy() for x in first]
    spec2 = P.make_random_spec(1, hidden=32, experts=3, device="cpu")
    second = ME._random_walk_graphed(spec2, init, 6, 3, 1.0, None)
    w = ME._WALKS["cpu"]
    assert w.step.captures == 1
    for s, run in ((spec, first), (spec2, second)):
        for a, b in zip(ME._random_walk_eager(s, init, 6, 3, 1.0, None), run):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(first, kept):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[1], second[1])
    ME._random_walk_graphed(spec, init, 7, 3, 1.0, None)
    assert ME._WALKS["cpu"] is not w and ME._WALKS["cpu"].step.captures == 1
