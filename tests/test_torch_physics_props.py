"""The engine's physical properties in the port, on the CPU: the five cases
of tests/test_physics.py (free fall, momentum conservation, the fixed-base
pendulum's period, the humanoid drop-and-stand, the self-collision
deflection) with their step counts and thresholds, driven through the port's
public API by `vid2player3d_torch.physics.probes`. All f32.
"""

import numpy as np
import torch

from vid2player3d_torch.physics import probes

torch.set_num_threads(1)


def test_free_fall():
    r = probes.free_fall(1, device="cpu")
    np.testing.assert_allclose(r["dz"].numpy(), r["dz_expected"], rtol=1e-3)
    np.testing.assert_allclose(r["vz"].numpy(), r["vz_expected"], rtol=1e-3)


def test_linear_momentum_conservation_no_gravity():
    """Linear momentum changes only by gravity's impulse while the joint's
    torques fly. Semi-implicit Euler drifts O(dt) under fast internal
    motion: 0.12 at dt = 1/480, as in the JAX test."""
    r = probes.momentum(1, device="cpu")
    np.testing.assert_allclose(r["p1"].numpy(), r["expected"].numpy(), atol=0.12)


def test_pendulum_frequency():
    """Near-fixed root, child pendulum of length L: after one period
    2π√(L/g) the angle is back at θ0, at half a period near −θ0 (0.02)."""
    r = probes.pendulum(1, device="cpu")
    angles, theta0 = r["angles"][:, 0].numpy(), r["theta0"]
    assert abs(angles[-1] - theta0) < 0.02, angles[-1]
    half = angles[r["steps"] // 2]
    assert abs(half + theta0) < 0.02, half


def test_humanoid_drop_and_stand():
    """The synthetic-SMPL humanoid dropped just above the ground with
    zero-pose PD targets: the pelvis stays above 0.8 m for 0.5 s, and by
    2.5 s the body has settled finite, above the ground, below 1.2 m, with
    its root velocities damped under 0.5."""
    r = probes.drop_and_stand(2, device="cpu")
    rp = r["root_pos_stand"].numpy()
    assert (rp[:, 2] > 0.8).all(), rp
    st = r["state"]
    for f in ("root_pos", "root_quat", "root_vel", "joint_quat", "joint_omega"):
        assert torch.isfinite(getattr(st, f)).all(), f
    rp = st.root_pos.numpy()
    assert (rp[:, 2] > 0.02).all(), rp
    assert (rp[:, 2] < 1.2).all(), rp
    assert st.root_vel.abs().max() < 0.5


def test_self_collision_arm_deflects_off_torso():
    """An arm PD-commanded into the torso passes through it with the
    self-collision pairs off (penetration above 0.05) and is deflected
    with them on (at least 0.04 less)."""
    r = probes.self_collision_deflection(1, device="cpu")
    assert bool(r["finite"])
    pen_off, pen_on = float(r["pen_off"][0]), float(r["pen_on"][0])
    assert pen_off > 0.05, pen_off
    assert pen_on < pen_off - 0.04, (pen_on, pen_off)
