"""The port's MotionVAE training slice against the JAX package, on the CPU in
float32: the pose dataset, two `train_epoch`s fed the JAX trainer's
reparameterization normals, checkpoints in both directions, the player spec
built from a trainer, and the random-walk harness.

The JAX trainer's normals are replayed from its keys: per epoch one split of
`trainer._key`, `fuse` (16) batches per group split from it, and
`fold_in(batch_key, step)` per optimizer step. Both trainers start from the
JAX init (copied through `mvae_params_from_jax`) and draw their schedules and
windows from their own numpy generators with the same seeds.
"""

import copy
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from vid2player3d_tpu.mvae import MVAEOption as JOpt
from vid2player3d_tpu.mvae import MVAETrainer as JTrainer
from vid2player3d_tpu.mvae import dataset as JD
from vid2player3d_tpu.mvae import eval as JE
from vid2player3d_tpu.tennis import player as JP
from vid2player3d_tpu.utils.checkpoint import _flatten
from vid2player3d_torch.mvae import MVAEOption, MVAETrainer
from vid2player3d_torch.mvae import dataset as TD
from vid2player3d_torch.mvae import eval as TE
from vid2player3d_torch.tennis import player as TP
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

EPOCHS, BATCHES = 2, 2


def tiny(cls, **kw):
    """`tests/test_mvae.py`'s tiny_opt widths, with the curriculum ramping
    over the two epochs (so teacher-forced and regressive windows both occur)
    and the mixed-phase schedule on."""
    opt = cls(latent_size=8, hidden_size=32, num_experts=3, nframes_seq=6, batch_size=8,
              predict_phase=True, curriculum_schedule=(0.0, 0.25),
              mixed_phase_schedule=((0.0, 1.0), (0.5, 0.1)), softmax_future=True,
              n_epochs=4, n_epochs_decay=4, lr=3e-4)
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def jax_normals(trainer, nb, fuse=16):
    """The JAX trainer's reparameterization normals for its next epoch:
    (nb, nsteps, B, latent)."""
    opt = trainer.opt
    nsteps = opt.nframes_seq - opt.num_future_predictions - opt.num_condition_frames + 1
    key, out, done = trainer._key, [], 0
    while done < nb:
        k = min(fuse, nb - done)
        key, sub = jax.random.split(key)
        for bk in jax.random.split(sub, k):
            out.append([np.asarray(jax.random.normal(jax.random.fold_in(bk, j),
                                                     (opt.batch_size, opt.latent_size)))
                        for j in range(nsteps)])
        done += k
    return np.asarray(out, np.float32)


def _record(trainer, name, log):
    fn = getattr(trainer, name)

    def wrapped(epoch):
        v = bool(fn(epoch))
        log.append((name, v))
        return v

    setattr(trainer, name, wrapped)


def _port_params(trainer):
    return CK.mvae_params_to_jax(trainer.model.state_dict())


# -- the dataset ---------------------------------------------------------------

def test_phase_from_hits_matches():
    hits = [(1, True), (5, False), (9, True), (9, False), (14, True)]
    for a, b in zip(JD.phase_from_hits(16, hits), TD.phase_from_hits(16, hits)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("options", [dict(), dict(condition_root_x_only=True),
                                     dict(no_condition_root_y=True,
                                          pose_feature=("joint_rotmat", "root_pos", "joint_pos"))])
def test_assemble_features_matches(options):
    """The canonical feature order whatever the option tuple's order.
    Tolerance 1e-6: the rot6d columns are copies, the rest numpy."""
    rng = np.random.default_rng(3)
    jp = rng.standard_normal((7, 24, 3)).astype(np.float32)
    rm = rng.standard_normal((7, 24, 3, 3)).astype(np.float32)
    a = JD.assemble_features(JOpt(**options), jp, rm)
    b = TD.assemble_features(MVAEOption(**options), jp, rm)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_synthetic_dataset_and_windows_match():
    """`make_synthetic_pose_dataset` (the angle-axis rotations in f32):
    windows, masks, phases bit for bit, features and stats within 1e-6; the
    same seed draws the same `sample_batch` windows."""
    jds = JD.make_synthetic_pose_dataset(tiny(JOpt), num_seqs=3, T=50, seed=1, hit_period=12)
    tds = TD.make_synthetic_pose_dataset(tiny(MVAEOption), num_seqs=3, T=50, seed=1,
                                         hit_period=12)
    np.testing.assert_array_equal(tds.rollouts, jds.rollouts)
    np.testing.assert_array_equal(tds.valid_arr, jds.valid_arr)
    np.testing.assert_array_equal(tds.phase_arr, jds.phase_arr)
    assert tds.seq_bounds == jds.seq_bounds
    np.testing.assert_allclose(tds.feature_arr, jds.feature_arr, rtol=0, atol=1e-6)
    for a, b in zip(jds.get_normalization_stats(), tds.get_normalization_stats()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for _ in range(2):
        (jf, jph), (tf, tph) = jds.sample_batch(5), tds.sample_batch(5)
        np.testing.assert_array_equal(tph, jph)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    tds.init_rollouts(4)
    jds.init_rollouts(4)
    np.testing.assert_array_equal(tds.rollouts, jds.rollouts)


def _videos(rng):
    def seq(T, player, fid):
        return {"player": player, "handness": "right", "start": 2, "point_idx": 0,
                "arrays": {"joint_pos": rng.standard_normal((T, 24, 3)).astype(np.float32),
                           "joint_rotmat": rng.standard_normal((T, 24, 3, 3)).astype(np.float32),
                           "valid": rng.random(T) > 0.1}}

    ann = [{"keyframes": [{"fid": 3, "fg": True}, {"fid": 15, "fg": False},
                          {"fid": 27, "fg": True}, {"fid": 40, "fg": False}]}]
    return [{"name": "v0", "background": "usopen", "gender": "male", "is_orig": True,
             "points_annotation": ann,
             "sequences": {"fg": [seq(40, "Federer", 0), seq(30, "Nadal", 1)],
                           "bg": [seq(35, "Federer", 2)]}},
            {"name": "v1", "background": "wimbledon", "gender": "male", "is_orig": False,
             "points_annotation": ann,
             "sequences": {"fg": [seq(32, "Federer", 3)], "bg": []}}]


def test_video_dataset_manifest_round_trip(tmp_path):
    """Both writers give the same files, and the readers the same dataset
    from them (filters: player, side, the phase's original annotations)."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JD.write_video_dataset(jdir, _videos(np.random.default_rng(5)))
    TD.write_video_dataset(tdir, _videos(np.random.default_rng(5)))
    for name in ("joint_pos.npy", "joint_rotmat.npy", "valid.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(tdir, name)),
                                      np.load(os.path.join(jdir, name)))
    with open(os.path.join(jdir, "manifest.json")) as a, \
            open(os.path.join(tdir, "manifest.json")) as b:
        assert a.read() == b.read()
    for side in ("fg", "both"):
        kw = dict(player_name=["Federer"], side=side, nframes_seq=4)
        jds = JD.load_video_dataset(tiny(JOpt, **kw), jdir)
        tds = TD.load_video_dataset(tiny(MVAEOption, **kw), jdir)
        np.testing.assert_array_equal(tds.rollouts, jds.rollouts)
        np.testing.assert_array_equal(tds.valid_arr, jds.valid_arr)
        np.testing.assert_array_equal(tds.phase_arr, jds.phase_arr)
        np.testing.assert_allclose(tds.feature_arr, jds.feature_arr, rtol=0, atol=1e-6)


# -- training ------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvae")
    jopt = tiny(JOpt, checkpoint_dir=str(root / "jax"))
    topt = tiny(MVAEOption, checkpoint_dir=str(root / "torch"))
    jtr = JTrainer(jopt, JD.make_synthetic_pose_dataset(jopt, num_seqs=3, T=60, seed=0))
    ttr = MVAETrainer(topt, TD.make_synthetic_pose_dataset(topt, num_seqs=3, T=60, seed=0),
                      device="cpu")
    with torch.no_grad():
        ttr.model.load_state_dict(CK.mvae_params_from_jax(_flatten(jtr.params)))
    p0 = {k: np.asarray(v) for k, v in _flatten(jtr.params).items()}
    jlog, tlog, jl, tl = [], [], [], []
    for tr, log in ((jtr, jlog), (ttr, tlog)):
        _record(tr, "_regressive", log)
        _record(tr, "_sample_phase", log)
    for _ in range(EPOCHS):
        eps = jax_normals(jtr, BATCHES)
        jl.append(jtr.train_epoch(batches_per_epoch=BATCHES))
        tl.append(ttr.train_epoch(batches_per_epoch=BATCHES, draws={"eps": eps}))
    return dict(jtr=jtr, ttr=ttr, p0=p0, jlog=jlog, tlog=tlog, jl=jl, tl=tl, root=root)


def test_schedule_choices_match(trained):
    assert trained["tlog"] == trained["jlog"]
    regs = [v for name, v in trained["jlog"] if name == "_regressive"]
    assert True in regs and False in regs


def test_losses_match(trained):
    """Each epoch's mean losses within 1e-5 relative (f32 sums in another
    order)."""
    for j, t in zip(trained["jl"], trained["tl"]):
        assert sorted(j) == sorted(t)
        for k in j:
            assert t[k] == pytest.approx(float(j[k]), rel=1e-5, abs=1e-7), k


def test_params_match(trained):
    """Params within 2·steps·lr elementwise, and the update within 1e-3 of
    its norm (the bounds of the port's PPO epoch tests): Adam turns f32
    rounding in a gradient near zero into a step of up to lr."""
    jtr, ttr, p0 = trained["jtr"], trained["ttr"], trained["p0"]
    opt = jtr.opt
    steps = EPOCHS * BATCHES * (opt.nframes_seq - 1)
    jp = {k: np.asarray(v) for k, v in _flatten(jtr.params).items()}
    tp = _port_params(ttr)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2 * steps * opt.lr, err_msg=k)
        du_j, du_t = jp[k] - p0[k], tp[k] - p0[k]
        assert np.linalg.norm(du_t - du_j) <= 1e-3 * np.linalg.norm(du_j) + 1e-12, k
    assert int(ttr.opt_state.count) == int(jtr.opt_state.inner_state[0].count) == steps
    assert ttr.epoch == jtr.epoch == EPOCHS
    assert ttr.current_lr() == pytest.approx(jtr.current_lr())


def test_checkpoints_cross_both_ways(trained):
    """The port's checkpoint directory loads into a JAX trainer, and the
    JAX trainer's into a port trainer: every key, exact values."""
    jtr, ttr = trained["jtr"], trained["ttr"]
    ttr.save_checkpoint()
    jtr.save_checkpoint()
    tdir = os.path.join(ttr.opt.checkpoint_dir, ttr.opt.model_ver)
    jdir = os.path.join(jtr.opt.checkpoint_dir, jtr.opt.model_ver)
    for name in ("latest.npz", "avg.npy", "std.npy", "init_frames.npy"):
        assert os.path.exists(os.path.join(tdir, name))
    tz, jz = np.load(os.path.join(tdir, "latest.npz")), np.load(os.path.join(jdir, "latest.npz"))
    assert sorted(tz.files) == sorted(jz.files)
    assert all(tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape for k in jz.files)
    # the init frames come from each dataset's own stream at the same place
    np.testing.assert_allclose(np.load(os.path.join(tdir, "init_frames.npy")),
                               np.load(os.path.join(jdir, "init_frames.npy")),
                               rtol=0, atol=1e-5)

    jopt = dataclasses.replace(jtr.opt, checkpoint_dir=ttr.opt.checkpoint_dir)
    j2 = JTrainer(jopt, JD.make_synthetic_pose_dataset(jopt, num_seqs=3, T=60, seed=4))
    j2.load_checkpoint()
    for k, v in _port_params(ttr).items():
        np.testing.assert_array_equal(np.asarray(_flatten(j2.params)[k]), v)
    np.testing.assert_array_equal(j2.dataset.std, ttr.dataset.std)

    topt = dataclasses.replace(ttr.opt, checkpoint_dir=jtr.opt.checkpoint_dir)
    t2 = MVAETrainer(topt, TD.make_synthetic_pose_dataset(topt, num_seqs=3, T=60, seed=4),
                     device="cpu")
    t2.load_checkpoint()
    for k, v in _flatten(jtr.params).items():
        np.testing.assert_array_equal(_port_params(t2)[k], np.asarray(v))
    np.testing.assert_array_equal(t2.dataset.avg, jtr.dataset.avg)

    bad = dataclasses.replace(topt, checkpoint_dir=str(trained["root"] / "bad"))
    os.makedirs(os.path.join(bad.checkpoint_dir, bad.model_ver))
    np.savez(os.path.join(bad.checkpoint_dir, bad.model_ver, "latest.npz"),
             **{k: v for k, v in _port_params(ttr).items() if "moe2" not in k})
    with pytest.raises(KeyError):
        MVAETrainer(bad, t2.dataset, device="cpu").load_checkpoint()


def test_spec_from_trainer_decodes_as_jax_and_is_a_snapshot(trained):
    """The spec's decode equals the JAX trainer's within 1e-5, and does not
    move when the trainer trains on."""
    jtr, ttr = trained["jtr"], trained["ttr"]
    rng = np.random.default_rng(9)
    z = rng.standard_normal((6, 8)).astype(np.float32)
    cond = rng.standard_normal((6, ttr.frame_size)).astype(np.float32)
    spec = TP.spec_from_trainer(ttr)
    jspec = JP.spec_from_trainer(jtr)
    feat, ph = spec.decode(torch.from_numpy(z), torch.from_numpy(cond))
    jfeat, jph = jspec.decode(jspec.params, z, cond)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=0, atol=1e-5)
    assert not any(p.requires_grad for p in spec.decoder.parameters())
    np.testing.assert_array_equal(spec.std.numpy(), ttr.dataset.std)

    moved = copy.deepcopy(ttr)
    moved.train_epoch(batches_per_epoch=1)
    spec2 = TP.spec_from_trainer(moved)
    after, _ = spec.decode(torch.from_numpy(z), torch.from_numpy(cond))
    np.testing.assert_array_equal(after.numpy(), feat.numpy())
    assert not torch.equal(spec2.decode(torch.from_numpy(z), torch.from_numpy(cond))[0], feat)


def test_random_walk_matches(trained):
    """30 random-walk steps with the JAX latents fed: trajectories within
    1e-4, metrics within 1e-3 relative."""
    jtr, ttr = trained["jtr"], trained["ttr"]
    init = jtr.dataset.raw_init_frames(4)
    steps, seed = 30, 3
    normals = np.stack([np.asarray(jax.random.normal(k, (4, 8)))
                        for k in jax.random.split(jax.random.PRNGKey(seed), steps)])
    jspec, spec = JP.spec_from_trainer(jtr), TP.spec_from_trainer(ttr)
    # the same decoder on both sides, so the rollout alone is compared
    with torch.no_grad():
        spec.decoder.load_state_dict(CK.mvae_params_from_jax(_flatten(jtr.params)))
    spec = dataclasses.replace(spec, avg=torch.from_numpy(np.asarray(jtr.dataset.avg)),
                               std=torch.from_numpy(np.asarray(jtr.dataset.std)))
    ja = JE.random_walk_rollout(jspec, init, steps, seed)
    ta = TE.random_walk_rollout(spec, init, steps, draws=normals)
    for a, b in zip(ja, ta):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    jm = JE.random_walk_metrics(jspec, init, steps, seed)
    tm = TE.random_walk_metrics(spec, init, steps, draws=normals)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        assert tm[k] == pytest.approx(float(jm[k]), rel=1e-3, abs=1e-6), k


def test_report_for_trainer_prefers_checkpoint_frames(trained, tmp_path):
    ttr = trained["ttr"]
    t2 = copy.deepcopy(ttr)
    t2.opt = dataclasses.replace(ttr.opt, checkpoint_dir=str(tmp_path))
    d = t2.checkpoint_dir()
    os.makedirs(d)
    frames = ttr.dataset.raw_init_frames(4)
    np.save(os.path.join(d, "init_frames.npy"), frames)
    rep = TE.report_for_trainer(t2, num_steps=20, num_envs=4)
    ref = TE.random_walk_metrics(TP.spec_from_trainer(t2), frames, 20, 0)
    assert rep == ref and rep["finite"]
