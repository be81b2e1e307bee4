"""The epochs replayed from CUDA graphs (``vid2player3d_torch/utils/graphs.py``),
on the CPU, where each `StaticGraph` runs its step on the static tensors as it
is (the path the card captures and replays).

- The staged imitation epoch (`ImitationPPO._train_epoch_graphed`) against
  the eager one (`_train_epoch_eager`), bit for bit over two epochs (the obs
  norm changes between them), with K1's plain version and the optax-chain
  Adam; against the JAX learner's epoch on its draws at
  `test_torch_epoch.py`'s bounds; a JAX checkpoint loaded after a capture
  takes a new key.
- `MVAETrainer.train_epoch(fuse=k)` (the staged windows) for k = 1, 2, 16 over
  5 windows: bit for bit with each other and with the eager windows, and
  against the JAX trainer's `train_epoch(fuse=k)` at
  `test_torch_mvae_train.py`'s bounds, fed its normals grouped by k.
- The signature of `train_epoch`, the configs that take the graphs, and the
  staged steps free of the ops a capture refuses (host syncs, host data).
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from test_torch_epoch import LR, METRIC_ATOL, MB, MINI_EPOCHS, N, SEED, T, _draws
from test_torch_mvae_train import jax_normals, tiny
from torch_dispatch import _refused
from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
from vid2player3d_tpu.envs import HumanoidImConfig as JEnvCfg
from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
from vid2player3d_tpu.learn import ImitationPPO as JPPO
from vid2player3d_tpu.learn import PPOConfig as JPPOCfg
from vid2player3d_tpu.mvae import MVAEOption as JOpt
from vid2player3d_tpu.mvae import MVAETrainer as JTrainer
from vid2player3d_tpu.mvae import dataset as JD
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib as t_make_lib
from vid2player3d_torch.envs import HumanoidImConfig, HumanoidImEnv
from vid2player3d_torch.envs.presets import preset
from vid2player3d_torch.learn import ImitationPPO, PPOConfig
from vid2player3d_torch.mvae import MVAEOption, MVAETrainer
from vid2player3d_torch.mvae import dataset as TD
from vid2player3d_torch.utils import checkpoint as CK
from vid2player3d_torch.utils import graphs

torch.set_num_threads(1)


def _agent(fused="on", schedule="constant", num_envs=4, motion_ids=None):
    env = HumanoidImEnv(HumanoidImConfig(num_envs=num_envs, substeps=2),
                        t_make_lib(num_motions=2, T=60, fps=30.0, seed=0, device="cpu"),
                        motion_ids=motion_ids, device="cpu")
    return ImitationPPO(env, PPOConfig(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS,
                                       learning_rate=LR, fused_optimizer=fused,
                                       lr_schedule=schedule), seed=SEED, device="cpu")


def _assert_same_state(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0, msg=k)
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for f in ("n", "mean", "var"):
        assert torch.equal(getattr(a.obs_norm, f), getattr(b.obs_norm, f)), f
        assert torch.equal(getattr(a.val_norm, f), getattr(b.val_norm, f)), f
    assert torch.equal(a.lr, b.lr) and a.epoch == b.epoch


def _assert_same_metrics(ma, mb):
    assert list(ma) == list(mb)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), (k, ma[k], mb[k])


@pytest.mark.parametrize("fused,schedule", [("on", "constant"), ("off", "adaptive"),
                                            ("on", "linear")])
def test_staged_epoch_equals_eager(fused, schedule):
    """Two epochs from two fresh states (one generator seed, so the same
    draws): params, moments, count, both norms, lr and every metric bit for
    bit. The second epoch runs under the first's obs norm, so a static copy
    read stale would show."""
    agent = _agent(fused, schedule)
    a, b = agent.init_state(), agent.init_state()
    norms = []
    for _ in range(2):
        a, ma = agent._train_epoch_eager(a)
        b, mb = agent._train_epoch_graphed(b)
        _assert_same_metrics(ma, mb)
        _assert_same_state(a, b)
        norms.append(b.obs_norm.mean.clone())
    assert not torch.equal(norms[0], norms[1])
    assert agent._st.step.captures == agent._st.update.captures == 1


@pytest.fixture(scope="module")
def jax_epoch(tmp_path_factory):
    """`test_torch_epoch.py`'s JAX epoch (the same program), its draws and
    its checkpoint."""
    jenv = JEnv(JEnvCfg(num_envs=N, substeps=2),
                j_make_lib(num_motions=2, T=60, fps=30.0, seed=0), rng=0)
    jagent = JPPO(jenv, JPPOCfg(horizon=T, minibatch_size=MB, mini_epochs=MINI_EPOCHS,
                                learning_rate=LR, fused_optimizer="on"), seed=SEED)
    jts0 = jagent.init_state()
    draws = _draws(jagent, jts0)
    init_params = CK.params_from_jax(_flatten(jts0.params))
    jts1, jm = jagent.train_epoch(jts0)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "jax_epoch1.npz")
    jagent.save_checkpoint(ckpt, jts1)
    return dict(draws=draws, init=init_params, jm={k: float(v) for k, v in jm.items()},
                jparams=CK.params_from_jax(_flatten(jts1.params)), ckpt=ckpt,
                motion_ids=np.asarray(jenv.motion_ids))


def test_staged_epoch_matches_jax(jax_epoch):
    """The staged epoch on the JAX learner's draws: metrics within
    `METRIC_ATOL` (1e-5 otherwise) and 1e-4 relative, params within 2·steps·lr
    of JAX's (the bounds of `test_torch_epoch.py`, whose docstring says
    why), and bit for bit with the eager epoch on the same draws."""
    agent = _agent(motion_ids=jax_epoch["motion_ids"])
    ts, m = agent._train_epoch_graphed(agent.init_state(jax_epoch["init"]),
                                       draws=jax_epoch["draws"])
    ref, mref = agent._train_epoch_eager(agent.init_state(jax_epoch["init"]),
                                         draws=jax_epoch["draws"])
    _assert_same_metrics(mref, m)
    _assert_same_state(ref, ts)
    jm = jax_epoch["jm"]
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), jm[k], atol=METRIC_ATOL.get(k, 1e-5),
                                   rtol=1e-4, err_msg=k)
    n_steps = MINI_EPOCHS * (N * T // MB)
    for k, v in ts.params.items():
        np.testing.assert_allclose(v.detach().numpy(), jax_epoch["jparams"][k].numpy(),
                                   atol=2 * n_steps * LR, err_msg=k)
    assert int(ts.opt_state.count) == n_steps


def test_checkpoint_after_capture_recaptures(jax_epoch):
    """A JAX checkpoint loaded into a learner that has captured gives new
    params and moments, so both graphs take a new key; the epoch from it
    equals the eager epoch from the same file bit for bit."""
    agent = _agent(motion_ids=jax_epoch["motion_ids"])
    agent._train_epoch_graphed(agent.init_state())
    st = agent._st
    keys = (st.step.key, st.update.key)
    ts, m = agent._train_epoch_graphed(agent.load_checkpoint(jax_epoch["ckpt"]))
    assert (st.step.captures, st.update.captures) == (2, 2)
    assert st.step.key != keys[0] and st.update.key != keys[1]
    ref, mref = agent._train_epoch_eager(agent.load_checkpoint(jax_epoch["ckpt"]))
    _assert_same_metrics(mref, m)
    _assert_same_state(ref, ts)
    assert ts.epoch == 2


BATCHES = 5


def _trainers():
    """A JAX and a port trainer from the JAX init, as
    `test_torch_mvae_train.py`'s fixture builds them."""
    jopt, topt = tiny(JOpt), tiny(MVAEOption)
    jtr = JTrainer(jopt, JD.make_synthetic_pose_dataset(jopt, num_seqs=3, T=60, seed=0))
    ttr = MVAETrainer(topt, TD.make_synthetic_pose_dataset(topt, num_seqs=3, T=60, seed=0),
                      device="cpu")
    with torch.no_grad():
        ttr.model.load_state_dict(CK.mvae_params_from_jax(_flatten(jtr.params)))
    return jtr, ttr


@pytest.mark.parametrize("fuse", [1, 2, 16])
def test_mvae_fuse_matches_eager_and_jax(fuse):
    """Two epochs of 5 windows: the staged windows grouped by `fuse` bit for
    bit with the eager windows (`train_epoch` on the CPU) on the same
    normals, and with JAX's `train_epoch(fuse=fuse)` fed its own normals
    (grouped by `fuse`): losses within 1e-5 relative, params within
    2·steps·lr (the bounds of `test_torch_mvae_train.py`)."""
    jtr, staged = _trainers()
    _, eager = _trainers()
    for _ in range(2):
        eps = jax_normals(jtr, BATCHES, fuse)
        jl = jtr.train_epoch(batches_per_epoch=BATCHES, fuse=fuse)
        sl = staged._train_epoch_graphed(BATCHES, fuse, draws={"eps": eps})
        el = eager.train_epoch(batches_per_epoch=BATCHES, fuse=fuse, draws={"eps": eps})
        assert sl == el
        for k in jl:
            assert sl[k] == pytest.approx(float(jl[k]), rel=1e-5, abs=1e-7), k
    for a, b in zip(staged.params, eager.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(staged.opt_state.count) == int(eager.opt_state.count)
    steps = 2 * BATCHES * (staged.opt.nframes_seq - 1)
    assert int(staged.opt_state.count) == steps
    jp = {k: np.asarray(v) for k, v in _flatten(jtr.params).items()}
    tp = CK.mvae_params_to_jax(staged.model.state_dict())
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2 * steps * staged.opt.lr,
                                   err_msg=k)


def test_mvae_fuse_groups_change_nothing():
    """Five windows from the trainer's own generator, fused by 1, 2 and 16:
    the same losses, params and count to the last bit (the draws come in
    the eager order whatever the grouping)."""
    runs = []
    for fuse in (1, 2, 16):
        _, tr = _trainers()
        losses = [tr._train_epoch_graphed(BATCHES, fuse) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in tr.params],
                     int(tr.opt_state.count)))
    for losses, params, count in runs[1:]:
        assert losses == runs[0][0] and count == runs[0][2]
        for a, b in zip(params, runs[0][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_epoch_signature_is_jaxs():
    """JAX's parameters, defaults and order, then `draws`."""
    jsig = inspect.signature(JTrainer.train_epoch).parameters
    tsig = inspect.signature(MVAETrainer.train_epoch).parameters
    assert list(tsig)[:len(jsig)] == list(jsig)
    assert list(tsig)[len(jsig):] == ["draws"]
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name
    assert tsig["draws"].default is None
    topt = tiny(MVAEOption)
    tr = MVAETrainer(topt, TD.make_synthetic_pose_dataset(topt, num_seqs=3, T=60, seed=0),
                     device="cpu")
    with pytest.raises(ValueError, match="fuse"):
        tr.train_epoch(batches_per_epoch=1, fuse=0)


@pytest.mark.parametrize("name,graphed", [
    ("amass_im", True), ("djokovic_im", True), ("federer_im", True), ("nadal_im", True),
    ("amass_im_dr", True), ("amass_im_corrupt", True)])
def test_which_configs_take_the_graphs(name, graphed):
    """On a card every imitation config replays its epochs from graphs,
    domain randomization and the context IK included. The predicate reads
    the config and the device only (here the device is set to the card's
    type without touching one)."""
    env_cfg, ppo_cfg = preset(name, num_envs=4)
    env = HumanoidImEnv(env_cfg, t_make_lib(num_motions=2, T=60, fps=30.0, seed=0,
                                            device="cpu"), device="cpu")
    agent = ImitationPPO(env, dataclasses.replace(ppo_cfg, horizon=T, minibatch_size=MB),
                         device="cpu")
    assert not agent.graphed
    agent.device = torch.device("cuda", 0)
    assert agent.graphed == graphed


@pytest.mark.parametrize("name", ["amass_im", "amass_im_dr", "amass_im_corrupt"])
def test_a_mesh_stays_eager(name):
    """A learner over a mesh (one rank here) stays eager on a card, whatever
    its config."""
    from vid2player3d_torch import parallel

    env_cfg, ppo_cfg = preset(name, num_envs=4)
    env = HumanoidImEnv(env_cfg, t_make_lib(num_motions=2, T=60, fps=30.0, seed=0,
                                            device="cpu"), device="cpu")
    mesh = parallel.data_parallel_mesh(device="cpu")
    agent = ImitationPPO(env.shard(mesh), dataclasses.replace(ppo_cfg, horizon=T,
                                                              minibatch_size=MB), mesh=mesh)
    agent.device = torch.device("cuda", 0)
    assert not agent.graphed


def test_staged_steps_hold_no_refused_op():
    """The three captured bodies (the env step with the policy, the
    optimizer step with K1's plain version and with the optax chain, the
    MotionVAE window) dispatch no op that syncs with the host, has a
    data-dependent shape or makes a tensor from host data."""
    for fused in ("on", "off"):
        agent = _agent(fused)
        ts, _ = agent._train_epoch_graphed(agent.init_state())
        st = agent._st
        st.row.zero_()
        assert _refused(st.step.body) == []
        st.row.zero_()
        assert _refused(st.update.body) == []
    _, tr = _trainers()
    tr._train_epoch_graphed(1, 1)
    assert _refused(tr._graph.window.body) == []
    # the check sees such ops
    assert _refused(lambda: torch.ones(2).sum().item()) == ["_local_scalar_dense"]
    assert _refused(lambda: torch.tensor([0.5, 0.5]) + 1.0) == ["host data"]
    assert _refused(lambda: torch.ones(3)[torch.ones(3) > 0]) != []
    assert _refused(lambda: torch.ones(3).__setitem__(torch.tensor([0, 2]), 0.0)) == [
        "host data", "scalar index_put"]


def test_static_graph_on_the_cpu_runs_its_body_and_counts_keys():
    """On the CPU `StaticGraph` runs the body every call and counts the keys
    it takes; the kernels' counters do not move."""
    x = torch.zeros(3)
    g = graphs.StaticGraph(lambda: x.add_(1.0), "cpu")
    before = [f.launches for f in graphs.counters()]
    for key in ("a", "a", "b", "b", "a"):
        g(key)
    assert torch.equal(x, torch.full((3,), 5.0))
    assert g.captures == 3 and g.key == "a"
    assert [f.launches for f in graphs.counters()] == before
    y = torch.zeros(2)
    assert graphs.tensor_key([x]) != graphs.tensor_key([y])
    assert graphs.tensor_key([x]) == graphs.tensor_key([x])
