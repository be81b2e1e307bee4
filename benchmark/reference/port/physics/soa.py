"""Structure-of-arrays (SoA) math core of the articulation engine (PyTorch).

Counterpart of ``vid2player3d_tpu/physics/soa.py``. The JAX package keeps
every component as its own (N,)-shaped array in a Python tuple; here the
components are stacked on the LEADING axes of one tensor, so the env axis
stays minor and contiguous and each operation is a few elementwise launches
over all components at once:

  v3  = tensor (3, *B)        x, y, z
  q4  = tensor (4, *B)        x, y, z, w (xyzw, matching core.quat)
  m33 = tensor (3, 3, *B)     row-major: m[r, c]

The formulas and their order of operations are those of the JAX package, so
the two agree up to float re-association.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


# ---------------------------------------------------------------------------
# vec3
# ---------------------------------------------------------------------------

def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=0)


def v_norm(a):
    return torch.sqrt(v_dot(a, a))


# ---------------------------------------------------------------------------
# quaternion (xyzw)
# ---------------------------------------------------------------------------

def q_mul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return torch.stack((w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2))


def q_conj(q):
    return torch.cat((-q[:3], q[3:]))


def q_normalize(q):
    """Sign-fix (w ≥ 0) + unit-normalize, matching `quat.quat_normalize`."""
    q = q * torch.where(q[3] < 0, -1.0, 1.0)
    x, y, z, w = q
    n = torch.clamp_min(torch.sqrt(x * x + y * y + z * z + w * w), _EPS)
    return q * (1.0 / n)


def q_mul_norm(a, b):
    return q_normalize(q_mul(a, b))


def q_rotate(q, v):
    """Rotate v by q (same formula as the JAX SoA core)."""
    qv, qw = q[:3], q[3]
    c = v_cross(qv, v)
    a = 2.0 * qw * qw - 1.0
    d = 2.0 * v_dot(qv, v)
    tw = 2.0 * qw
    return v * a + c * tw + qv * d


def q_rotate_inv(q, v):
    return q_rotate(q_conj(q), v)


def q_to_m33(q):
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack((
        torch.stack((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy))),
        torch.stack((2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx))),
        torch.stack((2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))))


def q_to_exp_map(q):
    """Angle wrapped to (-pi, pi], zero near identity (arccos form, as the
    JAX SoA core has it)."""
    min_theta = 1e-5
    w = torch.clamp(q[3], -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    angle = 2.0 * torch.arccos(w)
    angle = torch.atan2(torch.sin(angle), torch.cos(angle))
    scale = torch.where(sin_theta > min_theta,
                        angle / torch.clamp_min(sin_theta, _EPS), 0.0)
    return q[:3] * scale


def exp_map_to_q(e):
    """Matches `quat.exp_map_to_quat` (incl. angle wrap + default +z axis)."""
    min_theta = 1e-5
    angle = torch.sqrt(v_dot(e, e))
    inv = 1.0 / torch.clamp_min(angle, _EPS)
    angle_w = torch.atan2(torch.sin(angle), torch.cos(angle))
    mask = torch.abs(angle_w) > min_theta
    half = 0.5 * torch.where(mask, angle_w, 0.0)
    s = torch.sin(half)
    sx = torch.where(mask, e[0] * inv, 0.0) * s
    sy = torch.where(mask, e[1] * inv, 0.0) * s
    sz = torch.where(mask, e[2] * inv, 1.0) * s
    return torch.stack((sx, sy, sz, torch.cos(half)))


# ---------------------------------------------------------------------------
# mat33
# ---------------------------------------------------------------------------

def m_vec(m, v):
    """m @ v."""
    return m[:, 0] * v[0] + m[:, 1] * v[1] + m[:, 2] * v[2]


def mT_vec(m, v):
    """mᵀ @ v."""
    return m[0] * v[0] + m[1] * v[1] + m[2] * v[2]


def m_T(m):
    return m.transpose(0, 1)


def m_mul(a, b):
    """a @ b."""
    return (a[:, 0, None] * b[None, 0] + a[:, 1, None] * b[None, 1]
            + a[:, 2, None] * b[None, 2])


def mT_mul(a, b):
    """aᵀ @ b."""
    return (a[0][:, None] * b[None, 0] + a[1][:, None] * b[None, 1]
            + a[2][:, None] * b[None, 2])


def m_mulT(a, b):
    """a @ bᵀ."""
    return (a[:, 0, None] * b[None, :, 0] + a[:, 1, None] * b[None, :, 1]
            + a[:, 2, None] * b[None, :, 2])


def m_skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack((torch.stack((z, -v[2], v[1])),
                        torch.stack((v[2], z, -v[0])),
                        torch.stack((-v[1], v[0], z))))


def m_add_diag(m, d):
    """m + d·I₃."""
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return m + eye.reshape((3, 3) + (1,) * (m.dim() - 2)) * d


def m_inv(m):
    """Closed-form adjugate inverse (cofactor expansion)."""
    (a, b, c), (d, e, f), (g, h, i) = m
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    inv_det = 1.0 / (a * A + b * D + c * G)
    return torch.stack((torch.stack((A, B, C)), torch.stack((D, E, F)),
                        torch.stack((G, H, I)))) * inv_det


# ---------------------------------------------------------------------------
# spatial (6D) in block form: motion m = (ω v3, v v3); force f = (n v3, h v3)
# articulated-body inertia IA = (A m33, B m33, D m33) with full form
# [[A, B], [Bᵀ, D]], A and D symmetric.
# ---------------------------------------------------------------------------

def sp_cross_motion(v, m):
    """v ×ₘ m = [w×m1; w×m2 + u×m1]."""
    w, u = v
    m1, m2 = m
    return v_cross(w, m1), v_cross(w, m2) + v_cross(u, m1)


def sp_cross_force(v, f):
    """v ×* f = [w×n + u×h; w×h]."""
    w, u = v
    n, h = f
    return v_cross(w, n) + v_cross(u, h), v_cross(w, h)


def sp_xform_motion(E, p, m):
    """Parent→child motion transform: ω_c = E ω; v_c = E (v − p × ω)."""
    w, v = m
    return m_vec(E, w), m_vec(E, v - v_cross(p, w))


def sp_xform_force_to_parent(E, p, f):
    """Child→parent force transform (Xᵀ f): h_p = Eᵀ h; n_p = Eᵀ n + p × h_p."""
    n, h = f
    h_p = mT_vec(E, h)
    return mT_vec(E, n) + v_cross(p, h_p), h_p


def sp_inertia(mass, com, I_com):
    """Spatial inertia about the body origin as (A, B, D) blocks:
    A = I_com + m (|c|² I − c cᵀ), B = m ĉ, D = m I₃."""
    c2 = v_dot(com, com)
    A = I_com + mass * m_add_diag(-(com[:, None] * com[None]), c2)
    B = m_skew(com) * mass
    D = m_add_diag(torch.zeros_like(I_com), mass)
    return A, B, D


def sp_solve_sym66(A, B, D, b1, b2):
    """Solve [[A, B],[Bᵀ, D]] [x1; x2] = [b1; b2] via Schur complement on A."""
    Ai = m_inv(A)
    Ai_B = m_mul(Ai, B)
    S = D - mT_mul(B, Ai_B)          # D − Bᵀ A⁻¹ B
    Si = m_inv(S)
    y1 = m_vec(Ai, b1)
    x2 = m_vec(Si, b2 - mT_vec(B, y1))
    x1 = y1 - m_vec(Ai_B, x2)
    return x1, x2


def sp_xform_inertia_to_parent(E, p, A, B, D):
    """Xᵀ [[A,B],[Bᵀ,D]] X with X = [[E,0],[F,E]], F = −E p̂:
      T1 = A E + B F;  T2 = Bᵀ E + D F
      A' = Eᵀ T1 + Fᵀ T2;  B' = (Eᵀ B + Fᵀ D) E;  D' = Eᵀ D E
    """
    F = m_mul(E, m_skew(p)) * -1.0
    T1 = m_mul(A, E) + m_mul(B, F)
    T2 = mT_mul(B, E) + m_mul(D, F)
    Ap = mT_mul(E, T1) + mT_mul(F, T2)
    Bp = m_mul(mT_mul(E, B) + mT_mul(F, D), E)
    Dp = mT_mul(E, m_mul(D, E))
    return Ap, Bp, Dp
