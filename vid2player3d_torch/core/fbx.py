"""FBX importer (ASCII and binary) for skeleton animations.

Counterpart of ``vid2player3d_tpu/core/fbx.py``: small pure-Python parsers
read both the ASCII FBX 7.x format and the binary Kaydara container (no
native SDK, no subprocess) and produce `SkeletonTree` / `SkeletonMotion`
containers ready for retargeting (`core/skeleton.py`
`retarget_motion_by_tpose`). Everything runs on the host; the Euler and
PreRotation quaternion products are float32, as in the JAX package.

Scope: skeleton (LimbNode/Null/Root models), rest pose from
`Lcl Translation` / `Lcl Rotation` / `PreRotation` Properties70 entries, and
baked per-joint animation from AnimationCurveNode d|X/d|Y/d|Z curves
(KeyTime / KeyValueFloat, linear resampling to a fixed fps). Euler rotation
order XYZ (the FBX default). Both parsers emit the same `Node` tree, so
scene extraction is format-agnostic.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import quat as Q
from .skeleton import SkeletonMotion, SkeletonTree, _f32

FBX_TIME_PER_SECOND = 46186158000  # FBX KTime ticks per second


# ---------------------------------------------------------------------------
# ASCII record parser
# ---------------------------------------------------------------------------

class Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: List):
        self.name = name
        self.props = props
        self.children: List["Node"] = []

    def find(self, name: str) -> List["Node"]:
        return [c for c in self.children if c.name == name]

    def first(self, name: str) -> Optional["Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None


_TOKEN = re.compile(r'"(?:[^"\\]|\\.)*"|[^,]+')


def _parse_props(s: str) -> List:
    out = []
    for m in _TOKEN.finditer(s):
        tok = m.group(0).strip()
        if not tok:
            continue
        if tok.startswith('"'):
            out.append(tok[1:-1])
        else:
            try:
                out.append(int(tok))
            except ValueError:
                try:
                    out.append(float(tok))
                except ValueError:
                    out.append(tok)
    return out


_RECORD_START = re.compile(r'([A-Za-z0-9_|]+)\s*:')


def parse_fbx_ascii(text: str) -> Node:
    """Recursive-descent parse of the `Name: p1, p2 { ... }` record syntax.

    A record's property list ends at `{` (children follow), at a line break
    whose next non-blank content starts a new record or closes a block, or
    at `}`. Array payloads (`a: 1,2,\n3,4`) therefore continue across
    lines, matching FBX 7.x ASCII."""
    # strip per-line comments
    s = "\n".join(line.split(";")[0] for line in text.splitlines())
    n = len(s)
    pos = 0

    def skip_ws():
        nonlocal pos
        while pos < n and s[pos] in " \t\r\n":
            pos += 1

    def at_record_start() -> bool:
        m = _RECORD_START.match(s, pos)
        return m is not None

    def parse_children(parent: Node):
        nonlocal pos
        while True:
            skip_ws()
            if pos >= n:
                return
            if s[pos] == "}":
                pos += 1
                return
            m = _RECORD_START.match(s, pos)
            if m is None:
                pos += 1
                continue
            name = m.group(1)
            pos = m.end()
            props: List[str] = []
            buf: List[str] = []
            opened = False
            while pos < n:
                ch = s[pos]
                if ch == "{":
                    pos += 1
                    opened = True
                    break
                if ch == "}":
                    break
                if ch == "\n":
                    # lookahead: new record / block close ends this one;
                    # anything else (array continuation) keeps accumulating
                    save = pos
                    pos += 1
                    skip_ws()
                    if pos >= n or s[pos] == "}" or at_record_start():
                        pos = save
                        break
                    buf.append(" ")
                    continue
                buf.append(ch)
                pos += 1
            props = _parse_props("".join(buf))
            node = Node(name, props)
            parent.children.append(node)
            if opened:
                parse_children(node)

    root = Node("__root__", [])
    parse_children(root)
    return root


# ---------------------------------------------------------------------------
# binary (Kaydara) record parser
# ---------------------------------------------------------------------------

_BIN_MAGIC = b"Kaydara FBX Binary  \x00"

_SCALAR_FMT = {b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
               b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
_ARRAY_DTYPE = {b"f": np.float32, b"d": np.float64, b"l": np.int64,
                b"i": np.int32, b"b": np.uint8}


def _bin_string(raw: bytes) -> str:
    """Binary FBX stores names as 'Name\\x00\\x01Class'; ASCII writes
    'Class::Name'. Normalize to the ASCII convention so extraction code
    (`.split("::")[-1]`) works unchanged."""
    parts = raw.split(b"\x00\x01")
    parts = [p.decode("utf-8", errors="replace") for p in reversed(parts)]
    return "::".join(parts)


def parse_fbx_binary(data: bytes) -> Node:
    """Parse the binary FBX container into the same `Node` tree the ASCII
    parser produces (array payloads become an `a` child node, matching the
    7.x ASCII `KeyTime: *N { a: ... }` layout)."""
    if not data.startswith(_BIN_MAGIC):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", data, 23)[0]
    # v7.5 widened the record header fields to 64-bit
    wide = version >= 7500
    ofs_fmt, ofs_size = ("<Q", 8) if wide else ("<I", 4)
    sentinel = (3 * ofs_size + 1) * b"\x00"   # null record terminates a list

    def read_props(pos: int, count: int, node: Node) -> int:
        arrays = []
        for _ in range(count):
            code = data[pos:pos + 1]
            pos += 1
            if code in _SCALAR_FMT:
                fmt, size = _SCALAR_FMT[code]
                v = struct.unpack_from(fmt, data, pos)[0]
                pos += size
                node.props.append(bool(v) if code == b"C" else v)
            elif code in _ARRAY_DTYPE:
                n, enc, clen = struct.unpack_from("<III", data, pos)
                pos += 12
                dt = _ARRAY_DTYPE[code]
                if enc == 1:
                    raw = zlib.decompress(data[pos:pos + clen])
                    pos += clen
                else:
                    nbytes = n * dt().itemsize
                    raw = data[pos:pos + nbytes]
                    pos += nbytes
                arr = np.frombuffer(raw, dtype=dt)[:n]
                arrays.append(arr)
            elif code == b"S":
                n = struct.unpack_from("<I", data, pos)[0]
                pos += 4
                node.props.append(_bin_string(data[pos:pos + n]))
                pos += n
            elif code == b"R":
                n = struct.unpack_from("<I", data, pos)[0]
                pos += 4 + n
            else:
                raise ValueError(f"unknown FBX property type {code!r}")
        for arr in arrays:
            # mirror the ASCII `a:` child so `_array_values` finds it
            node.children.append(Node("a", [v.item() for v in arr]))
        return pos

    def read_node(pos: int):
        end = struct.unpack_from(ofs_fmt, data, pos)[0]
        nprops = struct.unpack_from(ofs_fmt, data, pos + ofs_size)[0]
        pos += 3 * ofs_size           # skip EndOffset/NumProps/PropListLen
        if end == 0:
            return None, pos + 1      # null record
        name_len = data[pos]
        pos += 1
        name = data[pos:pos + name_len].decode("utf-8", errors="replace")
        pos += name_len
        node = Node(name, [])
        pos = read_props(pos, nprops, node)
        while pos < end:
            if data[pos:pos + len(sentinel)] == sentinel:
                pos += len(sentinel)
                break
            child, pos = read_node(pos)
            if child is not None:
                node.children.append(child)
        return node, end

    root = Node("__root__", [])
    pos = 27
    while pos < len(data) - len(sentinel):
        if data[pos:pos + len(sentinel)] == sentinel:
            break
        node, pos = read_node(pos)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------------------
# scene extraction
# ---------------------------------------------------------------------------

def _prop70(node: Node, key: str) -> Optional[np.ndarray]:
    p70 = node.first("Properties70")
    if p70 is None:
        return None
    for p in p70.find("P"):
        if p.props and p.props[0] == key:
            vals = [v for v in p.props if isinstance(v, (int, float))]
            if len(vals) >= 3:
                return np.asarray(vals[-3:], np.float64)
    return None


def _euler_xyz_to_quat(deg: np.ndarray) -> np.ndarray:
    """FBX default rotation order XYZ (R = Rz·Ry·Rx applied to columns)."""
    r = np.deg2rad(np.asarray(deg, np.float64))
    half = r / 2.0
    cx, cy, cz = np.cos(half[..., 0]), np.cos(half[..., 1]), np.cos(half[..., 2])
    sx, sy, sz = np.sin(half[..., 0]), np.sin(half[..., 1]), np.sin(half[..., 2])
    qx = np.stack([sx, np.zeros_like(sx), np.zeros_like(sx), cx], -1)
    qy = np.stack([np.zeros_like(sy), sy, np.zeros_like(sy), cy], -1)
    qz = np.stack([np.zeros_like(sz), np.zeros_like(sz), sz, cz], -1)
    q = Q.quat_mul(_f32(qz), Q.quat_mul(_f32(qy), _f32(qx)))
    return q.numpy()


def import_fbx_motion(path: str, fps: float = 30.0,
                      root_joint: Optional[str] = None) -> SkeletonMotion:
    """Load an ASCII or binary FBX mocap file into a `SkeletonMotion`."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_BIN_MAGIC):
        doc = parse_fbx_binary(data)
    else:
        doc = parse_fbx_ascii(data.decode("utf-8", errors="replace"))

    objects = doc.first("Objects")
    conns = doc.first("Connections")
    if objects is None or conns is None:
        raise ValueError("not an FBX ASCII document (missing Objects/Connections)")

    # models (joints)
    models: Dict[int, Dict] = {}
    for m in objects.find("Model"):
        mid = m.props[0]
        name = str(m.props[1]).split("::")[-1].replace("\x00", "")
        models[mid] = dict(
            name=name,
            t=_prop70(m, "Lcl Translation"),
            r=_prop70(m, "Lcl Rotation"),
            pre=_prop70(m, "PreRotation"),
        )

    # curve nodes + curves
    curve_nodes: Dict[int, Dict] = {
        c.props[0]: dict(dx=None, dy=None, dz=None, target=None, channel=None)
        for c in objects.find("AnimationCurveNode")}
    def _array_values(node: Optional[Node]) -> np.ndarray:
        """FBX 7.x arrays live in an `a:` child (`KeyTime: *3 { a: 1,2,3 }`);
        6.x puts them inline."""
        if node is None:
            return np.zeros(0, np.float64)
        a = node.first("a")
        src = a.props if a is not None else \
            [p for p in node.props if isinstance(p, (int, float))]
        return np.asarray([v for v in src if isinstance(v, (int, float))],
                          np.float64)

    curves: Dict[int, Dict] = {}
    for c in objects.find("AnimationCurve"):
        times = _array_values(c.first("KeyTime"))
        vals = _array_values(c.first("KeyValueFloat"))
        if len(times) == 0 or len(vals) == 0:
            continue
        n = min(len(times), len(vals))
        curves[c.props[0]] = dict(t=times[:n] / FBX_TIME_PER_SECOND,
                                  v=vals[:n])

    # connections
    child_of: Dict[int, int] = {}
    for c in conns.find("C"):
        kind = c.props[0]
        if kind == "OO" and len(c.props) >= 3:
            a, b = c.props[1], c.props[2]
            if a in models and (b in models or b == 0):
                child_of[a] = b
            elif a in curves and b in curve_nodes:
                # curve -> curve node; channel name arrives via OP below or
                # ordering (X, Y, Z) — track insertion order
                cn = curve_nodes[b]
                for slot in ("dx", "dy", "dz"):
                    if cn[slot] is None:
                        cn[slot] = a
                        break
        elif kind == "OP" and len(c.props) >= 4:
            a, b, prop = c.props[1], c.props[2], str(c.props[3])
            if a in curves and b in curve_nodes:
                slot = {"d|X": "dx", "d|Y": "dy", "d|Z": "dz"}.get(prop)
                if slot:
                    curve_nodes[b][slot] = a
            elif a in curve_nodes and b in models:
                curve_nodes[a]["target"] = b
                curve_nodes[a]["channel"] = prop.split("|")[-1]

    # topological order of joints
    ids = [i for i in models
           if child_of.get(i, 0) == 0 or child_of.get(i) not in models]
    order: List[int] = []
    while ids:
        nid = ids.pop(0)
        order.append(nid)
        ids = [i for i, p in child_of.items()
               if p == nid and i not in order and i in models] + ids
    if root_joint is not None:
        ri = next(i for i in order if models[i]["name"] == root_joint)
        keep = {ri}
        changed = True
        while changed:
            changed = False
            for i, p in child_of.items():
                if p in keep and i not in keep and i in models:
                    keep.add(i)
                    changed = True
        order = [i for i in order if i in keep]

    id2row = {mid: k for k, mid in enumerate(order)}
    J = len(order)
    names = tuple(models[i]["name"] for i in order)
    parents = np.asarray(
        [id2row.get(child_of.get(i, 0), -1) for i in order], np.int32)
    local_t = np.zeros((J, 3), np.float32)
    for k, i in enumerate(order):
        t = models[i]["t"]
        local_t[k] = 0.0 if t is None else t
    tree = SkeletonTree(names, parents, torch.from_numpy(local_t))

    # animation span
    spans = [c["t"] for c in curves.values() if len(c["t"])]
    if spans:
        t0 = min(t[0] for t in spans)
        t1 = max(t[-1] for t in spans)
    else:
        t0 = t1 = 0.0
    T = max(int(round((t1 - t0) * fps)) + 1, 1)
    times = t0 + np.arange(T) / fps

    def sample(curve_id, default):
        if curve_id is None or curve_id not in curves:
            return np.full(T, default, np.float64)
        c = curves[curve_id]
        if len(c["t"]) == 0:
            return np.full(T, default, np.float64)
        return np.interp(times, c["t"], c["v"])

    rot_deg = np.zeros((T, J, 3), np.float64)
    trans = np.zeros((T, J, 3), np.float64)
    for k, i in enumerate(order):
        r = models[i]["r"]
        rot_deg[:, k] = 0.0 if r is None else r
        trans[:, k] = local_t[k]
    for cn in curve_nodes.values():
        tgt = cn["target"]
        if tgt is None or tgt not in id2row:
            continue
        k = id2row[tgt]
        if cn["channel"] == "Lcl Rotation":
            base = models[tgt]["r"]
            base = np.zeros(3) if base is None else base
            rot_deg[:, k, 0] = sample(cn["dx"], base[0])
            rot_deg[:, k, 1] = sample(cn["dy"], base[1])
            rot_deg[:, k, 2] = sample(cn["dz"], base[2])
        elif cn["channel"] == "Lcl Translation":
            base = models[tgt]["t"]
            base = np.zeros(3) if base is None else base
            trans[:, k, 0] = sample(cn["dx"], base[0])
            trans[:, k, 1] = sample(cn["dy"], base[1])
            trans[:, k, 2] = sample(cn["dz"], base[2])

    local_q = np.array(_euler_xyz_to_quat(rot_deg))  # (T, J, 4), writable
    for k, i in enumerate(order):
        pre = models[i]["pre"]
        if pre is not None:
            pq = _euler_xyz_to_quat(pre[None])      # (1, 4)
            local_q[:, k] = Q.quat_mul(_f32(np.broadcast_to(pq, (T, 4))),
                                       _f32(local_q[:, k])).numpy()

    return SkeletonMotion(tree=tree,
                          local_rotation=local_q.astype(np.float32),
                          root_translation=trans[:, 0].astype(np.float32),
                          fps=fps)
