"""6D spatial-vector algebra (Featherstone convention) on tensors.

Counterpart of ``vid2player3d_tpu/physics/spatial.py``. Motion vectors
m = [ω; v], force vectors f = [n; f], all expressed in body-local frames.
Every function broadcasts over leading batch dims; the matrices are 3x3 and
6x6. The engine (``physics/soa.py``) writes the same operations out in 3x3
block form; these are the whole-matrix forms.
"""

from __future__ import annotations

import torch


def _mv(M, v):
    """(..., i, j) @ (..., j) -> (..., i)."""
    return torch.einsum("...ij,...j->...i", M, v)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """(..., 3) → (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([
        zero, -z, y,
        z, zero, -x,
        -y, x, zero,
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia (6x6) about the body origin, body coords.

    mass (...,), com (..., 3) body-frame COM offset, inertia_com (..., 3, 3)
    rotational inertia about the COM.
    """
    c = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * (c @ c.transpose(-1, -2))
    top_right = m * c
    bot_left = m * c.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=top_left.dtype, device=top_left.device).expand(top_left.shape)
    bot_right = m * eye3
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, bot_right], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv33(M):
    """Closed-form adjugate inverse of (..., 3, 3) matrices: elementwise math
    over the batch, no batched LU."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    adj = torch.stack([A, B, C, D, E, F, G, H, I], dim=-1)
    return (adj * inv_det[..., None]).reshape(M.shape)


def solve_spd66(A, b):
    """Solve A x = b for symmetric positive-definite (..., 6, 6) A via 2x2-block
    Schur complement with closed-form 3x3 inverses (no batched LU)."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    A11i = inv33(A11)
    A11i_A12 = A11i @ A12
    S = A22 - A21 @ A11i_A12
    Si = inv33(S)
    y1 = _mv(A11i, b1)
    x2 = _mv(Si, b2 - _mv(A21, y1))
    x1 = y1 - _mv(A11i_A12, x2)
    return torch.cat([x1, x2], dim=-1)


def cross_motion(v, m):
    """v ×ₘ m for motion vectors: [w;u] × [m1;m2] = [w×m1; w×m2 + u×m1]."""
    w, u = v[..., :3], v[..., 3:]
    m1, m2 = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, m1), _cross(w, m2) + _cross(u, m1)], dim=-1)


def cross_force(v, f):
    """v ×* f for force vectors: [w;u] ×* [n;h] = [w×n + u×h; w×h]."""
    w, u = v[..., :3], v[..., 3:]
    n, h = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, n) + _cross(u, h), _cross(w, h)], dim=-1)


def xform_motion(E, p, m):
    """Transform motion vector from parent to child coords.

    E (..., 3, 3): rotation taking parent coords → child coords (R_child_in_parentᵀ);
    p (..., 3): child origin in parent frame. m (..., 6) in parent coords.
    """
    w, v = m[..., :3], m[..., 3:]
    w_c = _mv(E, w)
    v_c = _mv(E, v - _cross(p, w))
    return torch.cat([w_c, v_c], dim=-1)


def xform_force_to_parent(E, p, f):
    """Transform force vector from child coords back to parent coords (Xᵀ f)."""
    n, h = f[..., :3], f[..., 3:]
    Et = E.transpose(-1, -2)
    h_p = _mv(Et, h)
    n_p = _mv(Et, n) + _cross(p, h_p)
    return torch.cat([n_p, h_p], dim=-1)


def xform_inertia_to_parent(E, p, IA):
    """Transform an articulated-body inertia (6x6, child coords) to parent coords:
    Xᵀ IA X, with X built from (E, p)."""
    # X = [[E, 0], [-E p̂, E]]
    ph = skew(p)
    zero = torch.zeros_like(E)
    top = torch.cat([E, zero], dim=-1)
    bot = torch.cat([-E @ ph, E], dim=-1)
    X = torch.cat([top, bot], dim=-2)
    return X.transpose(-1, -2) @ IA @ X
