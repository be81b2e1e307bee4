"""Quaternion algebra in xyzw convention (PyTorch).

Counterpart of ``vid2player3d_tpu/core/quat.py``: the same functions under the
same names, over arbitrary leading batch dims, with singularities handled by
``torch.where`` masks (no data-dependent branches).

Convention: q = [x, y, z, w]; rotations are active; unit quaternions assumed
unless noted.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _unit(like, axis: int):
    """Tensor shaped like ``like`` holding the unit vector along ``axis``."""
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def normalize_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


# ---------------------------------------------------------------------------
# construction / normalization
# ---------------------------------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_from_angle_axis(angle, axis):
    """Quaternion from rotation `angle` about (unit or non-unit) `axis`."""
    axis = axis / torch.clamp_min(torch.linalg.norm(axis, dim=-1, keepdim=True), _EPS)
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw):
    """Intrinsic XYZ euler → quat."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    qw = cy * cp * cr + sy * sp * sr
    qx = cy * cp * sr - sy * sp * cr
    qy = cy * sp * cr + sy * cp * sr
    qz = sy * cp * cr - cy * sp * sr
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_pos(q):
    """Flip sign so the real (w) part is non-negative."""
    return torch.where(q[..., 3:] < 0, -q, q)


def quat_abs(q):
    return torch.linalg.norm(q, dim=-1)


def quat_unit(q):
    return q / torch.clamp_min(quat_abs(q)[..., None], _EPS)


def quat_normalize(q):
    return quat_unit(quat_pos(q))


# ---------------------------------------------------------------------------
# algebra
# ---------------------------------------------------------------------------

def quat_mul(a, b):
    """Hamilton product a*b, xyzw."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2
    z = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2
    return torch.stack([x, y, z, w], dim=-1)


def quat_mul_norm(a, b):
    return quat_normalize(quat_mul(a, b))


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


quat_inverse = quat_conjugate  # unit quaternions


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    q_w = q[..., 3:]
    q_vec = q[..., :3]
    q_vec, v = torch.broadcast_tensors(q_vec, v)
    a = v * (2.0 * q_w ** 2 - 1.0)
    b = torch.linalg.cross(q_vec, v, dim=-1) * q_w * 2.0
    c = q_vec * torch.sum(q_vec * v, dim=-1, keepdim=True) * 2.0
    return a + b + c


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conjugate(q), v)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def quat_to_angle_axis(q):
    """Return (angle, axis); angle wrapped to (-pi, pi], axis defaults to +z
    near identity. Uses atan2(|xyz|, w), which has finite gradients at
    identity where arccos(w) does not."""
    min_theta = 1e-5
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    s2 = torch.sum(q[..., :3] * q[..., :3], dim=-1)
    sin_theta = torch.sqrt(torch.clamp_min(s2, 1e-18))
    angle = normalize_angle(2 * torch.atan2(sin_theta, w))
    axis = q[..., :3] / torch.clamp_min(sin_theta[..., None], _EPS)
    mask = torch.abs(sin_theta) > min_theta
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit(axis, 2))
    return angle, axis


def angle_axis_to_exp_map(angle, axis):
    return angle[..., None] * axis


def quat_to_exp_map(q):
    angle, axis = quat_to_angle_axis(q)
    return angle_axis_to_exp_map(angle, axis)


def exp_map_to_angle_axis(exp_map):
    min_theta = 1e-5
    angle = torch.sqrt(torch.clamp_min(torch.sum(exp_map * exp_map, dim=-1), 1e-18))
    axis = exp_map / torch.clamp_min(angle[..., None], _EPS)
    angle = normalize_angle(angle)
    mask = torch.abs(angle) > min_theta
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit(exp_map, 2))
    return angle, axis


def exp_map_to_quat(exp_map):
    angle, axis = exp_map_to_angle_axis(exp_map)
    return quat_from_angle_axis(angle, axis)


def quat_to_tan_norm(q):
    """6D tangent+normal representation: rotated x-axis ++ rotated z-axis."""
    ref = q[..., 0:3]
    return torch.cat([quat_rotate(q, _unit(ref, 0)), quat_rotate(q, _unit(ref, 2))], dim=-1)


def quat_to_rotmat(q):
    """xyzw quaternion → 3x3 rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(m):
    """3x3 rotation matrix → xyzw quaternion (branch-free Shepperd: four
    candidates, the one with the largest pivot wins). The sqrt floor 1e-12
    keeps gradients of unselected candidates finite."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _psqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) / 2

    qw0 = _psqrt(1 + tr)
    s0 = torch.clamp_min(4 * qw0, _EPS)
    c0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, qw0], dim=-1)

    qx1 = _psqrt(1 + m00 - m11 - m22)
    s1 = torch.clamp_min(4 * qx1, _EPS)
    c1 = torch.stack([qx1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], dim=-1)

    qy2 = _psqrt(1 - m00 + m11 - m22)
    s2 = torch.clamp_min(4 * qy2, _EPS)
    c2 = torch.stack([(m01 + m10) / s2, qy2, (m12 + m21) / s2, (m02 - m20) / s2], dim=-1)

    qz3 = _psqrt(1 - m00 - m11 + m22)
    s3 = torch.clamp_min(4 * qz3, _EPS)
    c3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, qz3, (m10 - m01) / s3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    idx = best[..., None, None].expand(cands.shape[:-2] + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_unit(q)


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

def slerp(q0, q1, t):
    """Spherical interpolation with the reference's edge-case handling.
    `t` broadcastable to q[..., :1]."""
    cos_half = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where((cos_half < 0)[..., None], -q1, q1)
    cos_half = torch.abs(cos_half)[..., None]
    cos_half_c = torch.clamp(cos_half, 0.0, 1.0 - 1e-7)

    half = torch.arccos(cos_half_c)
    sin_half = torch.sqrt(1.0 - cos_half_c * cos_half_c)

    ratio_a = torch.sin((1 - t) * half) / torch.clamp_min(sin_half, _EPS)
    ratio_b = torch.sin(t * half) / torch.clamp_min(sin_half, _EPS)
    new_q = ratio_a * q0 + ratio_b * q1

    new_q = torch.where(torch.abs(sin_half) < 0.001, 0.5 * q0 + 0.5 * q1, new_q)
    new_q = torch.where(cos_half >= 1, q0, new_q)
    return new_q


# ---------------------------------------------------------------------------
# heading (direction on xy plane)
# ---------------------------------------------------------------------------

def calc_heading(q):
    rot_dir = quat_rotate(q, _unit(q[..., 0:3], 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q):
    return quat_from_angle_axis(calc_heading(q), _unit(q[..., 0:3], 2))


def calc_heading_quat_inv(q):
    return quat_from_angle_axis(-calc_heading(q), _unit(q[..., 0:3], 2))


def calc_heading_quat_inv_with_heading(q):
    heading = calc_heading(q)
    return quat_from_angle_axis(-heading, _unit(q[..., 0:3], 2)), heading


# SMPL rest orientation: the SMPL mesh's canonical frame differs from the env
# frame by this fixed rotation, [0.5, 0.5, 0.5, 0.5] (xyzw).


def remove_base_rot(q):
    # made on the device (no host-to-device copy, so a CUDA graph can hold it)
    base = torch.full_like(q, 0.5)
    return quat_mul(q, quat_conjugate(base))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def quat_angle(q, eps=1e-6):
    """Rotation angle magnitude of q (uses |w|)."""
    s = torch.clamp(2 * (q[..., 3] ** 2) - 1, -1 + eps, 1 - eps)
    return torch.arccos(s)


def quat_angle_diff(q1, q2):
    return quat_angle(quat_mul(q1, quat_conjugate(q2)))


def quat_between_two_vec(v1, v2, eps=1e-6):
    """Quaternion rotating v1 onto v2."""
    v1n = v1 / torch.clamp_min(torch.linalg.norm(v1, dim=-1, keepdim=True), _EPS)
    v2n = v2 / torch.clamp_min(torch.linalg.norm(v2, dim=-1, keepdim=True), _EPS)
    dot = torch.sum(v1n * v2n, dim=-1)
    cross = torch.linalg.cross(v1n, v2n, dim=-1)
    q = torch.cat([cross, (1 + dot)[..., None]], dim=-1)

    same = dot > 1 - eps
    q = torch.where(same[..., None], quat_identity(q.shape[:-1], q.dtype, q.device), q)

    opp = dot < -1 + eps
    use_y = torch.abs(v1n[..., 0]) >= 1 - eps
    perp_ref = torch.where(use_y[..., None], _unit(v1n, 1), _unit(v1n, 0))
    perp = torch.linalg.cross(perp_ref, v1n, dim=-1)
    perp = perp / torch.clamp_min(torch.linalg.norm(perp, dim=-1, keepdim=True), _EPS)
    q_pi = torch.cat([perp, torch.zeros_like(perp[..., :1])], dim=-1)
    q = torch.where(opp[..., None], q_pi, q)
    return quat_unit(q)


def heading_to_vec(h_theta):
    return torch.stack([torch.cos(h_theta), torch.sin(h_theta)], dim=-1)


def vec_to_heading(h_vec):
    return torch.atan2(h_vec[..., 1], h_vec[..., 0])
