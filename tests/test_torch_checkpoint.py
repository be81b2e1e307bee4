"""Checkpoints in the JAX package's layout, both ways: learner round trips
(the JAX learner writes, the port reads and writes back, the JAX package's
`load_pytree` reads the port's file with its own template), stage warm
starts against JAX's `load_stage_checkpoint`, the surgery unit case, ball
pools and motion libraries.

The learners are built over a stand-in env (the attributes a learner reads:
sizes, device, and a `reset_all` that returns zero observations), since no
checkpoint holds env state; their states are filled with seeded random
values so that every leaf is checked, not only the fresh init's zeros.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.data.motion_lib import MotionLib as JMotionLib
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.learn import V2PConfig as JV2PCfg
from vid2player3d_tpu.learn import V2PPPO as JV2P
from vid2player3d_tpu.tennis.ball import TennisBallGenerator as JBall
from vid2player3d_tpu.utils import checkpoint as JCK
from vid2player3d_torch.data.motion_lib import MotionLib
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.learn import ImitationPPO, PPOConfig, V2PConfig, V2PPPO
from vid2player3d_torch.tennis.ball import TennisBallGenerator
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

UNITS = dict(actor_units=(32, 16), critic_units=(32, 16))


def jax_env(num_envs, num_actions, obs_dim):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(num_envs=num_envs), num_actions=num_actions, obs_dim=obs_dim,
        reset_all=lambda key: (None, jnp.zeros((num_envs, obs_dim))))


def port_env(num_envs, num_actions, obs_dim):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(num_envs=num_envs), num_actions=num_actions, obs_dim=obs_dim,
        device=torch.device("cpu"), reset_all=lambda draws=None: (None, torch.zeros(num_envs, obs_dim)))


def randomized(ts, seed):
    """The JAX train state with every params/optimizer/norm leaf random
    (in each leaf's dtype; var positive), count 5, epoch 3, lr 3e-5."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(np.full(x.shape, 5, x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)).astype(x.dtype)

    def norm(n):
        return type(n)(n=jnp.asarray(100.0), mean=fill(n.mean),
                       var=jnp.asarray(rng.random(n.var.shape).astype(np.float32) + 0.1))

    return dataclasses.replace(
        ts, params=jax.tree_util.tree_map(fill, ts.params),
        opt_state=jax.tree_util.tree_map(fill, ts.opt_state),
        obs_norm=norm(ts.obs_norm), val_norm=norm(ts.val_norm),
        epoch=jnp.asarray(3, jnp.int32), lr=jnp.asarray(3e-5, jnp.float32))


def learner_like(ts):
    return {"params": ts.params, "obs_norm": ts.obs_norm, "val_norm": ts.val_norm,
            "opt_state": ts.opt_state, "epoch": ts.epoch, "lr": ts.lr}


def assert_files_equal(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_trees_equal(a, b):
    fa, fb = JCK._flatten(a), JCK._flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def round_trip(tmp_path, jagent, ts, tagent):
    """JAX file -> the port's load -> the port's save -> JAX `load_pytree`
    with the JAX learner's own template: equal, key for key, dtype for dtype
    and value for value, to the JAX learner's own load-and-save of the file
    (a load keeps the file's lr only under the adaptive schedule)."""
    jpath, jback, tpath = (str(tmp_path / n) for n in ("jax.npz", "jax_back.npz", "port.npz"))
    jagent.save_checkpoint(jpath, ts)
    if hasattr(jagent, "load_checkpoint"):
        jts = jagent.load_checkpoint(jpath)
        jagent.save_checkpoint(jback, jts)
    else:   # the JAX V2PPPO has no loader: the test runs it adaptive
        jts, jback = ts, jpath
    tts = tagent.load_checkpoint(jpath)
    tagent.save_checkpoint(tpath, tts)
    assert_files_equal(jback, tpath)
    assert_trees_equal(JCK.load_pytree(tpath, learner_like(ts)), learner_like(jts))
    # everything but lr is the written state itself
    assert_trees_equal(JCK.load_pytree(tpath, learner_like(ts))["opt_state"], ts.opt_state)
    return tts


# -- learner round trips ---------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(fused_optimizer="on", compute_dtype="bf16"),
                                dict(use_context_ik=True)],
                         ids=["optax_chain", "fused_bf16_moments", "context_ik"])
def test_imitation_round_trip(tmp_path, kw):
    jagent = JPPO(jax_env(4, 75, 734), JPPOCfg(horizon=4, minibatch_size=8, **kw), seed=7)
    tagent = ImitationPPO(port_env(4, 75, 734), PPOConfig(horizon=4, minibatch_size=8, **kw),
                          device="cpu")
    ts = randomized(jagent.init_state(), 0)
    tts = round_trip(tmp_path, jagent, ts, tagent)
    if kw.get("compute_dtype") == "bf16":
        assert tts.opt_state.mu[0].dtype == torch.bfloat16


@pytest.mark.parametrize("num_policies", [1, 2])
def test_v2p_round_trip(tmp_path, num_policies):
    cfg = dict(horizon=4, minibatch_size=8, num_policies=num_policies, lr_schedule="adaptive",
               **UNITS)
    jagent = JV2P(jax_env(4, 9, 12), JV2PCfg(**cfg))
    tagent = V2PPPO(port_env(4, 9, 12), V2PConfig(**cfg), device="cpu")
    ts = randomized(jagent.init_state(), 1)
    tts = round_trip(tmp_path, jagent, ts, tagent)
    if num_policies == 2:
        assert all(v.shape[0] == 2 for v in tts.params.values())


# -- stage warm starts ---------------------------------------------------------------

def port_state_as_jax(ts, jts):
    """The port's warm-started state in the JAX learner's tree."""
    flat = CK.learner_state_to_jax(ts.params, ts.opt_state, ts.obs_norm, ts.val_norm,
                                   ts.epoch, ts.lr)
    return {k: flat[k] for k in JCK._flatten(learner_like(jts))}


@pytest.mark.parametrize("case", ["stage1_to_stage2", "single_to_dual"])
def test_load_stage_checkpoint_matches_jax(tmp_path, case):
    """The port's `load_stage_checkpoint` equals JAX's on the same file,
    exactly: a stage-1 file into a learner with 3 more obs dims and 2 more
    actions (grown kernel rows, mu columns, biases, moments and norms
    padded; lr dropped under the constant schedule, epoch and count kept),
    and a single-policy file into num_policies=2 (tiled)."""
    src = dict(horizon=4, minibatch_size=8, learning_rate=1e-4, **UNITS)
    jsrc = JV2P(jax_env(4, 9, 12), JV2PCfg(**src))
    path = str(tmp_path / "stage1.npz")
    jsrc.save_checkpoint(path, randomized(jsrc.init_state(), 2))
    if case == "stage1_to_stage2":
        dst, dims = dict(src, learning_rate=2e-5), (4, 11, 15)
    else:
        dst, dims = dict(src, num_policies=2), (4, 9, 12)
    jdst = JV2P(jax_env(*dims), JV2PCfg(**dst))
    tdst = V2PPPO(port_env(*dims), V2PConfig(**dst), device="cpu")
    jts = jdst.load_stage_checkpoint(path)
    tts = tdst.load_stage_checkpoint(path, discard_sigma=True)
    want = JCK._flatten(learner_like(jts))
    got = port_state_as_jax(tts, jts)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(tts.lr) == pytest.approx(dst["learning_rate"]) and tts.epoch == 3
    if case == "stage1_to_stage2":
        kern = got["params/params/actor_mlp/Dense_0/kernel"]
        assert kern.shape == (15, 32) and not kern[12:].any()
        assert not got["params/params/mu/kernel"][:, 9:].any()
        assert not got["opt_state/1/nu/params/mu/bias"][9:].any()
        # the `var` override is keyed on a substring the running norm's
        # flattened keys (`obs_norm/2`) do not hold: grown var pads with 0,
        # in the JAX learner and so in the port
        assert not got["obs_norm/2"][12:].any()
    else:
        kern = got["params/params/actor_mlp/Dense_0/kernel"]
        np.testing.assert_array_equal(kern[0], kern[1])
    # pure: the agent's own fresh state is unchanged
    fresh = tdst.init_state()
    assert tts.params["mu.weight"].data_ptr() != fresh.params["mu.weight"].data_ptr()
    assert float(fresh.lr) == pytest.approx(dst["learning_rate"]) and fresh.epoch == 0


def test_surgery_unit_case(tmp_path):
    """`tests/test_mvae.py`'s surgery case on the port's `load_with_surgery`,
    a tiled leaf, a fill override, and a shrink that raises."""
    path = str(tmp_path / "ck.npz")
    CK.save_npz(path, {"dense/kernel": np.ones((4, 3), np.float32),
                       "dense/bias": np.ones((3,), np.float32),
                       "norm/var": np.full((2,), 2.0, np.float32)})
    like = {"dense/kernel": np.zeros((6, 5), np.float32), "dense/bias": np.zeros((5,), np.float32),
            "extra": np.full((2,), 7.0, np.float32), "norm/var": np.zeros((4,), np.float32)}
    got = CK.load_with_surgery(path, like, {"var": 1.0})
    np.testing.assert_array_equal(got["dense/kernel"][:4, :3], 1.0)
    np.testing.assert_array_equal(got["dense/kernel"][4:], 0.0)
    np.testing.assert_array_equal(got["dense/kernel"][:, 3:], 0.0)
    np.testing.assert_array_equal(got["dense/bias"], [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(got["extra"], 7.0)            # new key keeps fresh init
    np.testing.assert_array_equal(got["norm/var"], [2, 2, 1, 1])
    tiled = CK.load_with_surgery(path, {"dense/bias": np.zeros((2, 4), np.float32)})
    np.testing.assert_array_equal(tiled["dense/bias"], [[1, 1, 1, 0]] * 2)
    with pytest.raises(ValueError):
        CK.load_with_surgery(path, {"dense/kernel": np.zeros((3, 3), np.float32)})
    # the JAX surgery gives the same leaves on the same file
    jlike = {"dense": {"kernel": like["dense/kernel"], "bias": like["dense/bias"]},
             "extra": like["extra"], "norm": {"var": like["norm/var"]}}
    jgot = JCK._flatten(JCK.load_pytree_with_surgery(path, jlike, {"var": 1.0}))
    for k in jgot:
        np.testing.assert_array_equal(got[k], jgot[k])


# -- ball pools and motion libraries ---------------------------------------------------

def test_ball_pool_both_ways(tmp_path):
    gen = TennisBallGenerator(num_candidates=256, seed=3, device="cpu")
    tpath, jpath = str(tmp_path / "port_pool.npz"), str(tmp_path / "jax_pool.npz")
    gen.save_npz(tpath)
    jgen = JBall.from_npz(tpath)
    jgen.save_npz(jpath)
    back = TennisBallGenerator.from_npz(jpath, device="cpu")
    assert back.backend == jgen.backend == "offline"
    assert back.pool_size == jgen.pool_size == gen.pool_size
    assert back.traj_length == jgen.traj_length == gen.traj_length
    for name in ("traj_pool", "launch_pos", "launch_vel", "launch_vspin"):
        np.testing.assert_array_equal(np.asarray(getattr(jgen, name)), getattr(gen, name).numpy())
        np.testing.assert_array_equal(getattr(back, name).numpy(), getattr(gen, name).numpy())
    np.testing.assert_array_equal(back.x_order.numpy(), np.asarray(jgen.x_order))
    assert sorted(np.load(tpath).files) == sorted(np.load(jpath).files)


def _with_video(lib, seed):
    rng = np.random.default_rng(seed)
    F, M = lib.gts.shape[0], lib.num_motions
    return dataclasses.replace(
        lib, kp2d=torch.from_numpy(rng.standard_normal((F, 24, 3)).astype(np.float32)),
        cam_extrinsics=torch.from_numpy(rng.standard_normal((M, 4, 4)).astype(np.float32)))


def assert_libs_equal(jlib, tlib):
    for f in dataclasses.fields(JMotionLib):
        a, b = np.asarray(getattr(jlib, f.name)), getattr(tlib, f.name).numpy()
        assert a.shape == b.shape, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


@pytest.mark.parametrize("video", [False, True], ids=["plain", "kp2d"])
def test_motion_lib_both_ways(tmp_path, video):
    """save/load both ways (JAX's field names and dtypes in the file, int64
    indices in the port's memory), and merge against JAX's merge, where a
    library without kp2d drops the video metadata."""
    lib = make_synthetic_motion_lib(num_motions=2, T=20, seed=0, device="cpu")
    other = make_synthetic_motion_lib(num_motions=3, T=15, seed=1, device="cpu")
    if video:
        lib, other = _with_video(lib, 0), _with_video(other, 1)
    tpath, jpath = str(tmp_path / "port_lib.npz"), str(tmp_path / "jax_lib.npz")
    lib.save(tpath)
    jlib = JMotionLib.load(tpath)
    z = np.load(tpath)
    assert sorted(z.files) == sorted(f.name for f in dataclasses.fields(JMotionLib))
    for f in dataclasses.fields(JMotionLib):
        assert z[f.name].dtype == np.asarray(getattr(jlib, f.name)).dtype, f.name
    assert z["length_starts"].dtype == z["key_body_ids"].dtype == np.int32
    assert_libs_equal(jlib, lib)
    jlib.save(jpath)
    back = MotionLib.load(jpath, device="cpu")
    assert back.length_starts.dtype == back.key_body_ids.dtype == torch.int64
    assert back.has_kp2d == video
    assert_libs_equal(jlib, back)

    jother = JMotionLib.load(_saved(other, tmp_path / "other.npz"))
    assert_libs_equal(JMotionLib.merge([jlib, jother]), MotionLib.merge([lib, other]))
    if video:
        plain = dataclasses.replace(other, kp2d=torch.zeros((0, 24, 3)),
                                    cam_extrinsics=torch.zeros((0, 4, 4)))
        mixed = MotionLib.merge([lib, plain])
        assert not mixed.has_kp2d and mixed.cam_extrinsics.shape == (0, 4, 4)
        assert_libs_equal(JMotionLib.merge([jlib, JMotionLib.load(
            _saved(plain, tmp_path / "plain.npz"))]), mixed)


def _saved(lib, path):
    lib.save(str(path))
    return str(path)
