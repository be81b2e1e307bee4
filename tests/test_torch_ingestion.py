"""Parity of the port's AMASS conversion (`data/amass.py` `convert_amass_dir`,
`convert_amass_sequence`) with the JAX package's, on `tests/
test_data_ingestion.py`'s AMASS fixture (two SMPLH clips at 60 Hz) plus a
72-dim clip at 120 Hz under `mocap_frame_rate` with an unknown gender in a
subfolder, a clip too short to keep, and a file that is no npz; the saved
library read by the other package; one amass_im epoch on the converted
library (as the JAX test trains on it).

Tolerances (f32 on the CPU, as the motion-library tests hold them): frames
and per-motion metadata 2e-5, the finite-difference velocities 2e-4,
`min_verts_h` 1e-5, integer fields and `motion_dt` exact.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from test_data_ingestion import _write_amass_fixture
from vid2player3d_tpu.core import smpl as JS
from vid2player3d_tpu.data import amass as JAM
from vid2player3d_tpu.data.motion_lib import MotionLib as JMotionLib
from vid2player3d_torch.core import smpl as TS
from vid2player3d_torch.data import amass as TAM
from vid2player3d_torch.data.motion_lib import MotionLib, get_motion_state

torch.set_num_threads(1)

FRAME_ATOL, VEL_ATOL, MINV_ATOL = 2e-5, 2e-4, 1e-5
VEL_FIELDS = ("grvs", "gravs", "dvs")


def _write_fixture(d):
    _write_amass_fixture(d)                      # seq_0 (neutral), seq_1 (male): 90 @ 60 Hz
    rng = np.random.default_rng(1)
    sub = os.path.join(d, "subject")
    os.makedirs(sub)
    T = 200
    t = np.arange(T)[:, None] / 120.0
    poses = (0.3 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0, (1, 72)) * t)).astype(np.float32)
    np.savez(os.path.join(sub, "seq_2.npz"), poses=poses,
             trans=np.concatenate([0.4 * t, 0 * t, 0.9 + 0 * t], 1).astype(np.float32),
             betas=rng.uniform(-1, 1, 10).astype(np.float64), gender="unknown",
             mocap_frame_rate=np.float64(120.0))
    np.savez(os.path.join(d, "short.npz"), poses=np.zeros((18, 156), np.float32),
             trans=np.zeros((18, 3), np.float32), betas=np.zeros(16, np.float32),
             gender="female", mocap_framerate=np.float64(60.0))
    with open(os.path.join(d, "broken.npz"), "wb") as f:
        f.write(b"no zip here")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("amass"))
    _write_fixture(d)
    paths = {k: os.path.join(d, f"lib_{k}.npz") for k in ("torch", "jax")}
    got = TAM.convert_amass_dir(d, smpl_model=TS.make_synthetic_smpl(),
                                out_path=paths["torch"], device="cpu")
    want = JAM.convert_amass_dir(d, smpl_model=JS.make_synthetic_smpl(), out_path=paths["jax"])
    return got, want, paths


def _compare(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.device.type == "cpu" and tuple(a.shape) == b.shape, f.name
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
            continue
        assert a.dtype == torch.float32, f.name
        atol = VEL_ATOL if f.name in VEL_FIELDS else \
            MINV_ATOL if f.name == "motion_min_verts_h" else FRAME_ATOL
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol, err_msg=f.name)


def test_convert_amass_dir_matches_jax(converted):
    """Every MotionLib field of the converted directory against JAX's."""
    got, want, _ = converted
    _compare(got, want)


def test_convert_amass_dir_downsamples_and_skips(converted):
    """Three motions kept (the short clip and the broken file dropped), each
    at 30 fps exactly (60 Hz by 2, 120 Hz by 4), frames ceil(T / skip);
    genders neutral, male and the unknown one as neutral; the 16 betas cut
    to 10."""
    got, _, _ = converted
    assert got.num_motions == 3
    np.testing.assert_array_equal(got.motion_dt.numpy(), np.full(3, 1.0 / 30.0, np.float32))
    np.testing.assert_array_equal(got.motion_num_frames.numpy(), [45, 45, 50])
    np.testing.assert_array_equal(got.motion_bodies[:, 0].numpy(), [0.0, 1.0, 0.0])
    assert tuple(got.motion_bodies.shape) == (3, 11)
    assert torch.equal(got.key_body_ids, torch.tensor([3, 7, 17, 22]))


def test_convert_amass_sequence_matches_jax():
    """One sequence with a body scale and a short `min_verts_frames`: the
    motion's frames and min_verts_h against JAX's."""
    rng = np.random.default_rng(3)
    pose = (rng.standard_normal((24, 72)) * 0.3).astype(np.float32)
    trans = rng.standard_normal((24, 3)).astype(np.float32)
    betas = rng.standard_normal(10).astype(np.float32)
    kw = dict(gender="female", fps=25.0, body_scale=1.1, min_verts_frames=5)
    got = TAM.convert_amass_sequence(TS.make_synthetic_smpl(), pose, trans, betas, **kw)
    want = JAM.convert_amass_sequence(JS.make_synthetic_smpl(), pose, trans, betas, **kw)
    for k in ("local_rotation", "root_translation", "global_translation", "global_rotation"):
        np.testing.assert_allclose(getattr(got["motion"], k), getattr(want["motion"], k),
                                   rtol=0, atol=FRAME_ATOL, err_msg=k)
    np.testing.assert_array_equal(got["motion_body"], want["motion_body"])
    assert got["body_scale"] == want["body_scale"] and got["motion"].fps == 25.0
    assert abs(got["min_verts_h"] - want["min_verts_h"]) <= MINV_ATOL


@pytest.mark.parametrize("reader", ["torch_reads_jax", "jax_reads_torch"])
def test_saved_library_read_by_the_other_package(converted, reader):
    got, want, paths = converted
    if reader == "torch_reads_jax":
        _compare(MotionLib.load(paths["jax"], device="cpu"), want)
    else:
        _compare(got, JMotionLib.load(paths["torch"]))


def test_amass_im_epoch_on_converted_library(converted):
    """One amass_im epoch at 4 envs on the converted library read back from
    its file: finite metrics and a positive reward, finite states."""
    import dataclasses as dc

    from vid2player3d_torch.envs import HumanoidImEnv
    from vid2player3d_torch.envs.presets import preset
    from vid2player3d_torch.learn import ImitationPPO

    _, _, paths = converted
    lib = MotionLib.load(paths["torch"], device="cpu")
    st = get_motion_state(lib, torch.tensor([0, 1, 2]), torch.tensor([0.5, 0.7, 1.2]))
    assert all(bool(torch.isfinite(v).all()) for v in st.values())
    env_cfg, ppo_cfg = preset("amass_im", num_envs=4, substeps=2)
    agent = ImitationPPO(HumanoidImEnv(env_cfg, lib, rng=0, device="cpu"),
                         dc.replace(ppo_cfg, horizon=4, minibatch_size=8, mini_epochs=1),
                         seed=3, device="cpu")
    _, m = agent.train_epoch(agent.init_state())
    assert all(math.isfinite(float(v)) for v in m.values())
    assert float(m["reward_mean"]) > 0.0
