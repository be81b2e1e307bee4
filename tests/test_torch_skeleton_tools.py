"""Parity of the port's skeleton and SMPL tools with the JAX package's:
`global_to_local_rot` (and its round trip through `fk_local_to_global`),
`retarget_motion_by_tpose` of an imported FBX chain onto the humanoid tree,
the `to_dict` / `from_dict` forms read across the two packages,
`load_smpl_pkl` of a pickled body with a `scipy.sparse` J_regressor, and
`find_smpl_model` with and without a model file.

Tolerances (f32 on the CPU): rotations 1e-5 (a chain of normalized
quaternion products, an ulp apart per product between the frameworks),
retargeted local rotations and root 1e-5; dict forms and loaded SMPL arrays
equal.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from test_fbx import _fixture_text
from vid2player3d_tpu.core import fbx as JF
from vid2player3d_tpu.core import skeleton as JSK
from vid2player3d_tpu.core import smpl as JS
from vid2player3d_tpu.data import amass as JAM
from vid2player3d_torch.core import fbx as TF
from vid2player3d_torch.core import skeleton as TSK
from vid2player3d_torch.core import smpl as TS
from vid2player3d_torch.data import amass as TAM

torch.set_num_threads(1)

ATOL = 1e-5


def _trees(seed=0):
    betas = (np.random.default_rng(seed).standard_normal(10) * 0.5).astype(np.float32)
    return (TAM.humanoid_skeleton_tree(TS.make_synthetic_smpl(), betas),
            JAM.humanoid_skeleton_tree(JS.make_synthetic_smpl(), betas))


def _quats(shape, seed):
    q = np.random.default_rng(seed).standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _same_quat(a, b, atol=ATOL):
    """Equal as rotations: q and -q are the same."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    assert float(d.max()) <= atol, float(d.max())


def test_global_to_local_rot_matches_jax_and_round_trips():
    tt, jt = _trees()
    local = _quats((16, 24), 1)
    root = np.random.default_rng(2).standard_normal((16, 3)).astype(np.float32)
    g_rot = np.asarray(JSK.fk_local_to_global(jt, jnp.asarray(local), jnp.asarray(root))[0])
    want = np.asarray(JSK.global_to_local_rot(jt, jnp.asarray(g_rot)))
    got = TSK.global_to_local_rot(tt, torch.from_numpy(g_rot.copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # round trip: local -> global -> local gives the normalized input back
    g_t = TSK.fk_local_to_global(tt, torch.from_numpy(local), torch.from_numpy(root))[0]
    _same_quat(TSK.global_to_local_rot(tt, g_t).numpy(), local)
    assert tt.num_joints == jt.num_joints == 24


@pytest.mark.parametrize("align_deg,scale", [(90.0, 1.0), (-30.0, 0.8)])
def test_retarget_fbx_chain_matches_jax(align_deg, scale, tmp_path):
    """The 3-joint FBX chain (Hips -> Spine -> Head, a PreRotation on Spine)
    retargeted onto the humanoid tree by t-pose: every target joint's local
    rotation and the root translation equal JAX's within 1e-5."""
    path = os.path.join(tmp_path, "clip.fbx")
    with open(path, "w") as f:
        f.write(_fixture_text())
    src_t, src_j = TF.import_fbx_motion(path), JF.import_fbx_motion(path)
    tt, jt = _trees(3)
    h = np.deg2rad(align_deg) / 2
    align = np.array([np.sin(h), 0.0, 0.0, np.cos(h)])
    src_tpose = np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1))
    src_tpose[1] = src_t.local_rotation[0, 1]            # the PreRotation's rest pose
    tgt_tpose = np.tile(np.array([0, 0, 0, 1], np.float32), (24, 1))
    tgt_tpose[3] = _quats((), 5)                         # a bent target rest pose
    mapping = {"Hips": "Pelvis", "Spine": "Spine", "Head": "Head"}
    got = TSK.retarget_motion_by_tpose(src_t, src_tpose, tt, tgt_tpose, mapping, align, scale)
    want = JSK.retarget_motion_by_tpose(src_j, src_tpose, jt, tgt_tpose, mapping, align, scale)
    assert got.tree is tt and got.num_frames == want.num_frames == 31
    assert got.local_rotation.dtype == np.float32 and got.root_translation.dtype == np.float32
    np.testing.assert_allclose(got.local_rotation, want.local_rotation, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.root_translation, want.root_translation, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.global_rotation, want.global_rotation, rtol=0, atol=ATOL)
    # the mapped joints follow the source's rotation about the aligned axis
    assert not np.allclose(got.local_rotation[0, 0], got.local_rotation[-1, 0], atol=1e-3)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_dict_forms_cross_packages(direction):
    """`SkeletonTree.to_dict` / `SkeletonMotion.to_dict` of one package read
    by the other's `from_dict`: equal names, parents, translations, frames
    and fps; the reader's caches rebuilt."""
    tt, jt = _trees(6)
    rot = _quats((12, 24), 7)
    root = np.random.default_rng(8).standard_normal((12, 3)).astype(np.float32)
    if direction == "torch_to_jax":
        src = TSK.SkeletonMotion(tree=tt, local_rotation=rot, root_translation=root, fps=30.0)
        dst = JSK.SkeletonMotion.from_dict(src.to_dict())
        tree_d = JSK.SkeletonTree.from_dict(tt.to_dict())
        ref = JSK.SkeletonMotion(tree=jt, local_rotation=rot, root_translation=root, fps=30.0)
    else:
        src = JSK.SkeletonMotion(tree=jt, local_rotation=rot, root_translation=root, fps=30.0)
        dst = TSK.SkeletonMotion.from_dict(src.to_dict())
        tree_d = TSK.SkeletonTree.from_dict(jt.to_dict())
        ref = TSK.SkeletonMotion(tree=tt, local_rotation=rot, root_translation=root, fps=30.0)
    for tree in (tree_d, dst.tree):
        assert tree.node_names == tt.node_names == jt.node_names
        np.testing.assert_array_equal(np.asarray(tree.parent_indices), tt.parent_indices)
        np.testing.assert_array_equal(np.asarray(tree.local_translation),
                                      np.asarray(src.tree.local_translation))
    assert src.to_dict()["tree"] == tree_d.to_dict()
    np.testing.assert_array_equal(dst.local_rotation, rot)
    np.testing.assert_array_equal(dst.root_translation, root)
    assert dst.fps == 30.0
    np.testing.assert_allclose(dst.global_translation, ref.global_translation, rtol=0, atol=ATOL)


def _smpl_pkl(path, posedirs, seed=0):
    rng = np.random.default_rng(seed)
    V = 48
    reg = np.zeros((24, V))
    reg[np.arange(24), rng.integers(0, V, 24)] = 0.5
    reg[np.arange(24), rng.integers(0, V, 24)] += 0.5
    data = {"v_template": rng.standard_normal((V, 3)),
            "shapedirs": rng.standard_normal((V, 3, 16)) * 0.01,
            "J_regressor": scipy.sparse.csc_matrix(reg),
            "weights": rng.dirichlet(np.ones(24), V),
            "f": rng.integers(0, V, (10, 3))}
    if posedirs:
        data["posedirs"] = rng.standard_normal((V, 3, 207)) * 1e-3
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=2)
    return data


def _same_smpl(t, j):
    for k in ("v_template", "shapedirs", "J_regressor", "lbs_weights", "posedirs"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == torch.float32, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


@pytest.mark.parametrize("posedirs", [True, False])
def test_load_smpl_pkl_matches_jax(posedirs, tmp_path):
    """A pickled body (float64 leaves, 16 shape dirs, a sparse J_regressor):
    float32, the sparse leaf dense, 10 shape dirs kept, posedirs when the
    file has them; equal to JAX's, and its LBS equal to JAX's within 1e-5."""
    path = str(tmp_path / "body.pkl")
    data = _smpl_pkl(path, posedirs)
    got, want = TS.load_smpl_pkl(path), JS.load_smpl_pkl(path)
    _same_smpl(got, want)
    assert tuple(got.shapedirs.shape) == (48, 3, 10)
    np.testing.assert_array_equal(got.J_regressor.numpy(),
                                  data["J_regressor"].toarray().astype(np.float32))
    rng = np.random.default_rng(9)
    betas = (rng.standard_normal((2, 10)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((2, 72)) * 0.3).astype(np.float32)
    v_t, j_t = TS.lbs(got, torch.from_numpy(betas), torch.from_numpy(pose))
    v_j, j_j = JS.lbs(want, jnp.asarray(betas), jnp.asarray(pose))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(j_t.numpy(), np.asarray(j_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("present", [None, "SMPL_NEUTRAL.pkl",
                                     "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl",
                                     "SMPL_FEMALE.pkl"])
def test_find_smpl_model_matches_jax(present, tmp_path):
    """The same file-name search as JAX's: a file under one of the gender's
    names loads; with none (or only another gender's) the synthetic body."""
    d = str(tmp_path)
    if present:
        _smpl_pkl(os.path.join(d, present), posedirs=True)
    gender = "female" if present == "SMPL_FEMALE.pkl" else "neutral"
    for g in (gender, "male"):
        got, want = TS.find_smpl_model(d, g), JS.find_smpl_model(d, g)
        _same_smpl(got, want)
        found = present is not None and g == gender
        assert (got.num_verts == 48) == found
        if not found:
            _same_smpl(got, TS.make_synthetic_smpl())
