"""Golden-physics probes of the engine, batched over identical envs.

The five physical-property cases the JAX package's engine is tested on
(``tests/test_physics.py``): free fall, linear momentum under internal
torques, the fixed-base pendulum's period, the humanoid's drop-and-stand and
the self-collision deflection of an arm driven into the trunk. Each runs
`num_envs` copies of its case on `device` (the card unless given) through the
engine's public API and returns per-env measurements, on the device, with
the analytic values they are held to; the caller applies the thresholds.
Nothing syncs with the host inside a run.

On a CUDA device each run's step is captured once in a CUDA graph and
replayed (`utils.graphs.StaticGraph`): the eager engine is host-bound
(~6,800 small ops per humanoid substep), and a replay launches the same
kernels without the host.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..core import quat as Q
from ..core import smpl as S
from ..utils.graphs import StaticGraph
from ..utils.runtime import resolve_device
from . import asset, engine
from .model import ArticulationModel, ArticulationState

G = 9.81
STATE_FIELDS = ("root_pos", "root_quat", "root_vel", "joint_quat", "joint_omega")


def _stepper(state: ArticulationState, step) -> tuple:
    """(live, loop): `live` holds the state's tensors, which `loop(n)`
    moves forward by n applications of `step` (state -> state); on a CUDA
    device the first application also captures it, the others replay it."""
    live = {f: getattr(state, f).clone() for f in STATE_FIELDS}

    def advance():
        new = step(ArticulationState(**live))
        for f in STATE_FIELDS:
            live[f].copy_(getattr(new, f))

    graph = StaticGraph(advance, state.root_pos.device)

    def loop(n: int) -> None:
        for _ in range(n):
            graph()

    return live, loop


def two_body_model(num_envs: int = 1, root_mass: float = 1.0, child_mass: float = 1.0,
                   arm: float = 0.5, kp: float = 0.0, kd: float = 0.0,
                   device=None) -> ArticulationModel:
    """Root + one child body whose COM hangs `arm` below the joint (a
    pendulum), one small contact sphere on the root."""
    device = resolve_device(device)

    def tile(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return x.expand(num_envs, *x.shape).contiguous()

    def full(v):
        return torch.full((num_envs, 1), float(v), device=device)

    return ArticulationModel(
        parents=(-1, 0),
        names=("root", "child"),
        joint_pos=tile(np.zeros((2, 3))),
        body_com=tile([[0.0, 0.0, 0.0], [0.0, 0.0, -arm]]),
        body_mass=tile([root_mass, child_mass]),
        body_inertia=tile(np.stack([np.eye(3) * 0.1, np.eye(3) * 1e-4])),
        kp=full(kp), kd=full(kd), torque_lim=full(1e6), armature=full(0.0),
        contact_body=(0,),
        contact_offset=torch.zeros((num_envs, 1, 3), device=device),
        contact_radius=full(0.01),
    )


def free_fall(num_envs: int = 1, device=None, steps: int = 120,
              dt: float = 1.0 / 240.0) -> Dict:
    """Drop from 10 m for `steps` substeps: the root's fall `dz` and vertical
    velocity `vz`, beside semi-implicit Euler's closed form."""
    model = two_body_model(num_envs, device=device)
    state = ArticulationState.zeros(num_envs, 2, root_h=10.0, device=model.device)
    pd = torch.zeros((num_envs, 3), device=model.device)
    live, loop = _stepper(state, lambda s: engine.substep(model, s, pd, dt=dt))
    loop(steps)
    return dict(dz=live["root_pos"][:, 2] - 10.0, vz=live["root_vel"][:, 5],
                dz_expected=-G * dt * dt * steps * (steps + 1) / 2,
                vz_expected=-G * dt * steps)


def linear_momentum(model: ArticulationModel, state: ArticulationState) -> torch.Tensor:
    """(N, 3) total linear momentum, Σ m_j · v_com_j."""
    _, bq, bl, ba = engine.rigid_body_state(model, state)
    com_w = Q.quat_rotate(bq, model.body_com)
    v_com = bl + torch.cross(ba, com_w, dim=-1)
    return (model.body_mass[..., None] * v_com).sum(dim=1)


def momentum(num_envs: int = 1, device=None, steps: int = 240,
             dt: float = 1.0 / 480.0) -> Dict:
    """Two bodies far from the ground, the joint spun against PD torques:
    the final momentum `p1` and `expected`, the initial one plus gravity's
    impulse (internal torques move no momentum)."""
    model = two_body_model(num_envs, root_mass=2.0, child_mass=1.0, kp=50.0, kd=1.0,
                           device=device)
    dev = model.device
    rest = ArticulationState.zeros(num_envs, 2, root_h=100.0, device=dev)
    state = ArticulationState(
        root_pos=rest.root_pos, root_quat=rest.root_quat,
        root_vel=torch.tensor([0.3, -0.2, 0.1, 1.0, 2.0, 0.5], device=dev).repeat(num_envs, 1),
        joint_quat=rest.joint_quat,
        joint_omega=torch.tensor([3.0, -2.0, 1.0], device=dev).repeat(num_envs, 1, 1))
    p0 = linear_momentum(model, state)
    pd = torch.zeros((num_envs, 3), device=dev)
    live, loop = _stepper(state, lambda s: engine.substep(model, s, pd, dt=dt))
    loop(steps)
    impulse = torch.tensor([0.0, 0.0, -G * dt * steps], device=dev)
    return dict(p1=linear_momentum(model, ArticulationState(**live)),
                expected=p0 + model.body_mass.sum(dim=1, keepdim=True) * impulse)


def pendulum(num_envs: int = 1, device=None, length: float = 0.5, theta0: float = 0.1,
             dt: float = 1.0 / 960.0) -> Dict:
    """A point-ish mass on an arm of `length` under a fixed base, released
    from `theta0` about x, for one small-oscillation period 2π√(L/g):
    `angles` (steps, N), the joint angle after each substep."""
    model = two_body_model(num_envs, root_mass=1e6, child_mass=1.0, arm=length,
                           device=device)
    dev = model.device
    half = theta0 / 2
    state = ArticulationState(
        root_pos=torch.tensor([0.0, 0.0, 5.0], device=dev).repeat(num_envs, 1),
        root_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(num_envs, 1),
        root_vel=torch.zeros((num_envs, 6), device=dev),
        joint_quat=torch.tensor([math.sin(half), 0.0, 0.0, math.cos(half)],
                                device=dev).repeat(num_envs, 1, 1),
        joint_omega=torch.zeros((num_envs, 1, 3), device=dev))
    period = 2 * math.pi * math.sqrt(length / G)
    steps = int(period / dt)
    pd = torch.zeros((num_envs, 3), device=dev)
    angles = torch.empty((steps, num_envs), device=dev)
    row = torch.zeros(1, dtype=torch.long, device=dev)      # the next row of `angles`

    def step(s):
        s = engine.substep(model, s, pd, dt=dt, fixed_base=True)
        angles.index_copy_(0, row, 2 * torch.asin(s.joint_quat[None, :, 0, 0].clamp(-1.0, 1.0)))
        row.add_(1)
        return s

    _, loop = _stepper(state, step)
    loop(steps)
    return dict(angles=angles, theta0=theta0, steps=steps)


def drop_and_stand(num_envs: int = 2, device=None, dt: float = 1.0 / 240.0,
                   stand_steps: int = 120, settle_steps: int = 480) -> Dict:
    """The synthetic-SMPL humanoid (zero betas) dropped 5 cm above its feet
    with zero-pose PD targets: the root after `stand_steps` substeps
    (`root_pos_stand`) and the state after `settle_steps` more (`state`)."""
    device = resolve_device(device)
    body = S.make_synthetic_smpl()
    model = asset.build_humanoid_model(body, np.zeros((num_envs, 10), np.float32),
                                       device=device)
    lowest = float(asset.min_verts_height(body, np.zeros((1, 10), np.float32))[0])
    state = asset.default_humanoid_state(model, num_envs, root_h=-lowest + 0.05)
    pd = torch.zeros((num_envs, model.num_dof), device=device)
    live, loop = _stepper(state, lambda s: engine.substep(model, s, pd, dt=dt))
    loop(stand_steps)
    root_pos_stand = live["root_pos"].clone()
    loop(settle_steps)
    return dict(root_pos_stand=root_pos_stand, state=ArticulationState(**live))


def self_collision_deflection(num_envs: int = 1, device=None, control_steps: int = 40,
                              substeps: int = 4) -> Dict:
    """The right arm PD-driven forward, across and folded into the trunk
    (zero betas, root at 0.92 m), once with the curated self-collision
    pairs off and once on: per env the deepest sphere-pair penetration over
    the run (`pen_off`, `pen_on`), and whether every body stayed finite."""
    device = resolve_device(device)
    body = S.make_synthetic_smpl()
    betas = np.zeros((num_envs, 10), np.float32)
    models = {sc: asset.build_humanoid_model(body, betas, self_collision=sc, device=device)
              for sc in (False, True)}
    idx = {n: i for i, n in enumerate(models[False].names)}
    tar = torch.zeros((num_envs, 23, 3), device=device)
    tar[:, idx["R_Shoulder"] - 1] = torch.tensor([0.0, 0.0, 2.2], device=device)
    tar[:, idx["R_Elbow"] - 1] = torch.tensor([0.0, -1.8, 0.0], device=device)
    tar = tar.reshape(num_envs, 69)
    pairs = torch.tensor(models[True].collision_pairs, device=device)
    out = {}
    finite = torch.ones((), dtype=torch.bool, device=device)
    for sc, model in models.items():
        off = model.contact_offset[:, :24]
        rad = model.contact_radius[:, :24]
        worst = torch.full((num_envs,), -math.inf, device=device)

        def step(s, model=model, off=off, rad=rad, worst=worst):
            s = engine.control_step(model, s, tar, substeps=substeps)
            bp, bq, _, _ = engine.rigid_body_state(model, s)
            cw = bp + Q.quat_rotate(bq, off)
            d = torch.linalg.vector_norm(cw[:, pairs[:, 0]] - cw[:, pairs[:, 1]], dim=-1)
            torch.maximum(worst, (rad[:, pairs[:, 0]] + rad[:, pairs[:, 1]] - d).amax(dim=1),
                          out=worst)
            finite.logical_and_(torch.isfinite(bp).all())
            return s

        _, loop = _stepper(asset.default_humanoid_state(model, num_envs, root_h=0.92), step)
        loop(control_steps)
        out["pen_on" if sc else "pen_off"] = worst
    out["finite"] = finite
    return out
