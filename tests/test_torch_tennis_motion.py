"""Parity of the port's synthetic tennis-motion generator
(`data/tennis_motion.py`) with the JAX package's.

The rig is float64 numpy in both packages, so given the same `Skeleton`
arrays and seed `generate_rally_sequence` is held bit for bit (the same
draws in the same order through the same operations), and so are
`mirror_sequence` and `measure_head_speed`. `Skeleton.from_smpl` runs the
SMPL rest-joint regression in float32 in each framework: held to 1e-6. The
dataset and the motion library start from each package's own skeleton, so
they are held at tolerances: dataset arrays 1e-5 (the 1e-7 skeleton
difference moved through the rig), motion-library frames 2e-5 and
finite-difference velocities 2e-4 (as the motion-library tests hold them),
with the 128-frame padding of both.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from vid2player3d_tpu.data import tennis_motion as JTM
from vid2player3d_tpu.mvae import MVAEOption as JOption
from vid2player3d_tpu.mvae.dataset import load_video_dataset as j_load
from vid2player3d_torch.data import tennis_motion as TTM
from vid2player3d_torch.mvae import MVAEOption
from vid2player3d_torch.mvae.dataset import load_video_dataset as t_load

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def skels():
    j = JTM.Skeleton.from_smpl()
    return j, TTM.Skeleton(rest=j.rest.copy(), offsets=j.offsets.copy(), parents=j.parents)


def _same_seq(a, b):
    for k in ("joint_pos", "joint_rotmat"):
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["hits"] == b["hits"]


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {"n_cycles": 3, "swing_speed": 1.3}),
                                     (2, {"n_cycles": 2, "noise": 0.0, "fps": 25.0})])
def test_generate_rally_sequence_bit_for_bit(skels, seed, kw):
    j, t = skels
    want = JTM.generate_rally_sequence(np.random.default_rng(seed), j, **kw)
    got = TTM.generate_rally_sequence(np.random.default_rng(seed), t, **kw)
    _same_seq(got, want)


@pytest.mark.parametrize("betas", [None, "random"])
def test_skeleton_from_smpl(betas):
    b = None if betas is None else (np.random.default_rng(4).standard_normal(10) * 0.7
                                    ).astype(np.float32)
    j, t = JTM.Skeleton.from_smpl(betas=b), TTM.Skeleton.from_smpl(betas=b)
    assert t.rest.dtype == t.offsets.dtype == np.float64
    np.testing.assert_allclose(t.rest, j.rest, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.offsets, j.offsets, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.parents, j.parents)
    np.testing.assert_allclose(TTM.R_ROOT0, JTM.R_ROOT0, rtol=0, atol=0)


def test_mirror_and_head_speed_bit_for_bit(skels):
    """`mirror_sequence` of a rally, and `measure_head_speed` of it and of its
    mirror (left-handed), equal JAX's."""
    j, t = skels
    seq = JTM.generate_rally_sequence(np.random.default_rng(5), j, n_cycles=3)
    _same_seq(TTM.mirror_sequence(seq), JTM.mirror_sequence(seq))
    for s, right in ((seq, True), (JTM.mirror_sequence(seq), False)):
        got = TTM.measure_head_speed(s, t, righthand=right)
        want = JTM.measure_head_speed(s, j, righthand=right)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].size == 3


@pytest.mark.parametrize("righthand", [True, False])
def test_generate_tennis_dataset_cross_read(righthand, tmp_path):
    """Both packages write a 2-sequence dataset: the same manifest, arrays
    within 1e-5; each package's `load_video_dataset` reads the other's
    directory into the same windows as its own."""
    kw = dict(num_sequences=2, cycles_per_seq=2, seed=1, righthand=righthand,
              player="Nadal" if not righthand else "Federer")
    dirs = {"torch": TTM.generate_tennis_dataset(str(tmp_path / "t"), **kw),
            "jax": JTM.generate_tennis_dataset(str(tmp_path / "j"), **kw)}
    man = [json.load(open(os.path.join(d, "manifest.json"))) for d in dirs.values()]
    assert man[0] == man[1] and len(man[0]) == 2
    for f in ("joint_pos", "joint_rotmat", "valid"):
        a, b = (np.load(os.path.join(d, f + ".npy")) for d in dirs.values())
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
    opt_kw = dict(player_name=[kw["player"]], nframes_seq=8)
    for load, opt in ((t_load, MVAEOption(**opt_kw)), (j_load, JOption(**opt_kw))):
        own, other = load(opt, dirs["torch"]), load(opt, dirs["jax"])
        assert len(own.rollouts) == len(other.rollouts) > 100
        np.testing.assert_allclose(own.feature_arr, other.feature_arr, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(own.phase_arr, other.phase_arr)


def test_tennis_motion_lib_matches_jax(tmp_path):
    """`tennis_motion_lib(num_sequences=4)` on the CPU: every field against
    JAX's (each rally padded to a multiple of 128 frames in both), and the
    saved file read by JAX."""
    from vid2player3d_tpu.data.motion_lib import MotionLib as JMotionLib

    path = str(tmp_path / "lib.npz")
    got = TTM.tennis_motion_lib(num_sequences=4, out_path=path, device="cpu")
    want = JTM.tennis_motion_lib(num_sequences=4)
    assert got.num_motions == 4 and not np.any(got.motion_num_frames.numpy() % 128)
    back = JMotionLib.load(path)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert a.shape == b.shape, f.name
        atol = 2e-4 if f.name in ("grvs", "gravs", "dvs") else 2e-5
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f.name)
        np.testing.assert_array_equal(np.asarray(getattr(back, f.name)), a.astype(
            np.int32 if a.dtype.kind in "iu" else np.float32), err_msg=f.name)


def test_main_writes_the_dataset_and_reports(tmp_path, capsys):
    """`_main` writes the dataset and prints the head-speed report JAX's
    prints for the same arguments."""
    args = ["--num_sequences", "2", "--cycles_per_seq", "2", "--seed", "3", "--lefthand"]
    TTM._main([str(tmp_path / "t")] + args)
    JTM._main([str(tmp_path / "j")] + args)
    got, want = (ln.split("  ", 1)[1] for ln in capsys.readouterr().out.strip().splitlines())
    assert got == want and got.startswith("head_speed@contact m/s: mean=")
    man = json.load(open(tmp_path / "t" / "manifest.json"))
    assert [v["sequences"]["fg"][0]["handness"] for v in man] == ["left", "left"]
