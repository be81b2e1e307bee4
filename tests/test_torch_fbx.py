"""Parity of the port's FBX importer (`core/fbx.py`) with the JAX package's, on
`tests/test_fbx.py`'s fixtures (the 3-joint ASCII scene, its binary twin,
the compressed key-time array, the truncated file) and on the 24-joint
SMPL-named chain `chip_smoke.py` writes for the card (ASCII, binary with raw
and with zlib arrays).

Tolerances: the parsed `Node` trees are equal (names, props, children, in
order); an imported motion's tree (names, parents, rest translations) and
root translation are equal, its local rotations within 1e-6 (the Euler and
PreRotation quaternion products run in float32 in both packages, and
XLA's and torch's products may round an ulp apart).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke as CS
from test_fbx import _fixture_binary, _fixture_text
from vid2player3d_tpu.core import fbx as JF
from vid2player3d_torch.core import fbx as TF

torch.set_num_threads(1)


def _tree(node):
    return (node.name, list(node.props), [_tree(c) for c in node.children])


def _chain_ascii():
    return CS.fbx_ascii(CS._fbx_scene())


def _chain_binary(compress=True):
    return CS.fbx_binary(CS._fbx_scene(), compress=compress)


FIXTURES = {
    "ascii": lambda: _fixture_text(),
    "binary": lambda: _fixture_binary(),
    "chain_ascii": _chain_ascii,
    "chain_binary": _chain_binary,
    "chain_binary_raw": lambda: _chain_binary(compress=False),
}


def _parse(mod, data):
    return mod.parse_fbx_binary(data) if isinstance(data, bytes) else mod.parse_fbx_ascii(data)


def _write(tmp_path, name, data):
    path = os.path.join(tmp_path, name + ".fbx")
    with open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_node_tree_matches_jax(name):
    data = FIXTURES[name]()
    assert _tree(_parse(TF, data)) == _tree(_parse(JF, data))


def _same_motion(got, want, rot_atol=1e-6):
    assert got.tree.node_names == want.tree.node_names
    np.testing.assert_array_equal(np.asarray(got.tree.parent_indices),
                                  np.asarray(want.tree.parent_indices))
    np.testing.assert_array_equal(got.tree.local_translation.numpy(),
                                  np.asarray(want.tree.local_translation))
    assert got.local_rotation.dtype == np.float32 and got.fps == want.fps
    assert got.local_rotation.shape == want.local_rotation.shape
    np.testing.assert_allclose(got.local_rotation, want.local_rotation, rtol=0, atol=rot_atol)
    np.testing.assert_array_equal(got.root_translation, want.root_translation)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_import_motion_matches_jax(name, tmp_path):
    """The tree, the local rotations (1e-6) and the root translation
    (exact) of `import_fbx_motion` equal JAX's; the chain's ASCII and
    binary files import to the same motion."""
    path = _write(tmp_path, name, FIXTURES[name]())
    got = TF.import_fbx_motion(path, fps=30.0)
    _same_motion(got, JF.import_fbx_motion(path, fps=30.0))
    if name.startswith("chain"):
        ref = TF.import_fbx_motion(_write(tmp_path, "ref", _chain_ascii()), fps=30.0)
        assert got.num_frames == int(CS.FBX_SECONDS * 30) + 1
        np.testing.assert_array_equal(got.local_rotation, ref.local_rotation)
        np.testing.assert_array_equal(got.root_translation, ref.root_translation)


@pytest.mark.parametrize("root,fps", [("Spine", 30.0), ("L_Hip", 24.0), ("Chest", 60.0)])
def test_import_root_joint_matches_jax(root, fps, tmp_path):
    """`root_joint=` keeps the subtree under the named joint, at another
    sampling rate too."""
    path = _write(tmp_path, "chain", _chain_ascii() if root != "Spine" else _fixture_text())
    got = TF.import_fbx_motion(path, fps=fps, root_joint=root)
    assert got.tree.node_names[0] == root and got.tree.parent_indices[0] == -1
    _same_motion(got, JF.import_fbx_motion(path, fps=fps, root_joint=root))


def test_compressed_arrays_match_jax():
    """zlib-compressed int64 and float32 payloads decode as JAX's and as the
    raw ones."""
    vals = list(range(10))
    floats = np.linspace(-1.5, 2.5, 7).astype(np.float32)

    def record(name, code, fmt, xs, enc):
        raw = b"".join(struct.pack(fmt, x) for x in xs)
        body = zlib.compress(raw) if enc else raw
        return name, code + struct.pack("<III", len(xs), enc, len(body)) + body

    for enc in (0, 1):
        doc = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
        for name, plist in (record(b"KeyTime", b"l", "<q", vals, enc),
                            record(b"KeyValueFloat", b"f", "<f", floats, enc)):
            end = len(doc) + 13 + len(name) + len(plist)
            doc += struct.pack("<IIIB", end, 1, len(plist), len(name)) + name + plist
        doc += b"\x00" * 13
        got = TF.parse_fbx_binary(doc)
        assert _tree(got) == _tree(JF.parse_fbx_binary(doc))
        assert got.first("KeyTime").first("a").props == vals
        assert got.first("KeyValueFloat").first("a").props == floats.tolist()


@pytest.mark.parametrize("data,match", [
    (b"Kaydara FBX Binary  \x00\x1a\x00" + b"\x28\x1c\x00\x00", "Objects"),
    (b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400) + b"\x00" * 13, "Objects"),
    (b"; FBX 7.4 project file\nFBXHeaderExtension:  {\n}\n", "Objects"),
], ids=["header_only", "no_records", "ascii_without_objects"])
def test_unreadable_file_raises_as_jax(data, match, tmp_path):
    """A header-only binary, one with no records, and an ASCII file without
    Objects raise ValueError in both packages; so does a buffer without the
    binary magic handed to the binary parser."""
    path = _write(tmp_path, "bad", data if data.startswith(b"Kaydara") else data.decode())
    for mod in (TF, JF):
        with pytest.raises(ValueError, match=match):
            mod.import_fbx_motion(path)
        with pytest.raises(ValueError, match="not a binary FBX file"):
            mod.parse_fbx_binary(b"Kaydara FBX ASCII")


def test_euler_and_prop70_match_jax():
    """`_euler_xyz_to_quat` at seeded angles (degrees, over ±400) within 1e-6,
    and `_prop70`'s last-three-numbers rule, against JAX's."""
    deg = np.random.default_rng(0).uniform(-400, 400, (64, 3))
    np.testing.assert_allclose(TF._euler_xyz_to_quat(deg), np.asarray(JF._euler_xyz_to_quat(deg)),
                               rtol=0, atol=1e-6)
    assert TF._euler_xyz_to_quat(deg).dtype == np.float32
    model = TF.parse_fbx_ascii(_fixture_text()).first("Objects").find("Model")[1]
    for key in ("Lcl Translation", "PreRotation", "Lcl Rotation"):
        got, want = TF._prop70(model, key), JF._prop70(model, key)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert TF.FBX_TIME_PER_SECOND == JF.FBX_TIME_PER_SECOND
