"""Rotation-representation conversions: rotation matrix / rot6d / angle-axis / euler.

Counterpart of ``vid2player3d_tpu/core/rot.py``, built on the xyzw quaternion
core in ``quat.py``. rot6d is the first two COLUMNS of the rotation matrix,
concatenated.
"""

from __future__ import annotations

import torch

from . import quat as Q

_EPS = 1e-8


def _normalize(x, eps=_EPS):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), eps)


# ---------------------------------------------------------------------------
# angle-axis (exponential map)
# ---------------------------------------------------------------------------

def angle_axis_to_rotmat(aa):
    """Rodrigues formula; aa (..., 3)."""
    return Q.quat_to_rotmat(Q.exp_map_to_quat(aa))


def rotmat_to_angle_axis(m):
    return Q.quat_to_exp_map(Q.rotmat_to_quat(m))


def angle_axis_to_quat(aa):
    return Q.exp_map_to_quat(aa)


def quat_to_angle_axis_vec(q):
    return Q.quat_to_exp_map(q)


# ---------------------------------------------------------------------------
# rot6d (first two columns of R)
# ---------------------------------------------------------------------------

def rotmat_to_rot6d(m):
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def rot6d_to_rotmat(r6, eps=_EPS):
    a1 = r6[..., :3]
    a2 = r6[..., 3:]
    deg1 = torch.linalg.norm(a1, dim=-1, keepdim=True) < eps
    a1 = torch.where(deg1, Q._unit(a1, 0), a1)
    b1 = _normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    deg2 = torch.linalg.norm(b2, dim=-1, keepdim=True) < eps
    b2 = torch.where(deg2, Q._unit(b2, 1), _normalize(b2))
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def angle_axis_to_rot6d(aa):
    return rotmat_to_rot6d(angle_axis_to_rotmat(aa))


def rot6d_to_angle_axis(r6):
    return rotmat_to_angle_axis(rot6d_to_rotmat(r6))


def quat_to_rot6d(q):
    return rotmat_to_rot6d(Q.quat_to_rotmat(q))


def rot6d_to_quat(r6):
    return Q.rotmat_to_quat(rot6d_to_rotmat(r6))


# ---------------------------------------------------------------------------
# yaw-pitch-roll euler
# ---------------------------------------------------------------------------

def safe_atan2(y, x, eps=1e-8):
    both_small = (torch.abs(y) < eps) & (torch.abs(x) < eps)
    y = torch.where(both_small, y + eps, y)
    return torch.atan2(y, x)


def ypr_euler_from_quat(q, eps=1e-6):
    """Quat → (roll, pitch, yaw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = safe_atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z), eps)
    pitch = torch.arcsin(torch.clamp(2 * (w * y - x * z), -1 + eps, 1 - eps))
    roll = safe_atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y), eps)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_from_ypr_euler(angles):
    """(roll, pitch, yaw) → quat."""
    half = angles * 0.5
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([x, y, z, w], dim=-1)


def get_heading_q(q):
    """Project quat onto its z-rotation (heading) component by zeroing x,y."""
    q_new = q.clone()
    q_new[..., 0:2] = 0.0
    return _normalize(q_new)


def deheading_quat(q, heading_q=None):
    if heading_q is None:
        heading_q = get_heading_q(q)
    return Q.quat_mul(Q.quat_conjugate(heading_q), q)
