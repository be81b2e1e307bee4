"""Tennis-ball flight: aerodynamics, bounce, trajectory pool, estimator.

Counterpart of ``vid2player3d_tpu/tennis/ball.py``. Flight is a
closed-form-force integration (gravity, quadratic drag, Magnus lift,
restitution bounce with Coulomb friction); the JAX package's two nested
`lax.scan`s are two Python loops here. Constants: m=0.057 kg, R=0.032 m,
rho=1.21, CD=0.55, CL = 1/(2 + |v/v_spin|) with its sign from top/backspin,
ground restitution 0.9, friction 0.2. Spin is a signed scalar `vspin` in rev/s,
positive topspin; its world angular-velocity vector is
`2*pi*vspin * normalize(cross(vel, -z))`.

The pool generator draws its candidate launches from a `torch.Generator`
seeded by `seed` (on the CPU, so every device gets the same pool), and
`from_arrays` loads a pool made elsewhere. Its candidates fly through
`simulate_flight` on the device, or through the native C++ integrator on the
host (`backend="native"`, ``native/ballsim.py``). `estimate_in` is the
dual-play hand-off: the opponent's outgoing ball mirrored through the net.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.runtime import as_draw, resolve_device
from . import court


class BallParams(NamedTuple):
    mass: float = 0.057
    radius: float = 0.032
    rho: float = 1.21
    gravity: float = 9.81
    base_cd: float = 0.55
    restitution: float = 0.9   # ball-court COR
    friction: float = 0.2
    spin_scale: float = 5.0

    @property
    def kf(self) -> float:
        return self.rho * np.pi * self.radius ** 2 / 2.0


DEFAULT_PARAMS = BallParams()


def _cross_down(v):
    """cross(v, [0, 0, -1]) = (-v_y, v_x, 0)."""
    return torch.stack([-v[..., 1], v[..., 0], torch.zeros_like(v[..., 0])], dim=-1)


def _norm(v, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def spin_vector(vel, vspin):
    """Signed rev/s scalar -> world angular velocity; axis =
    normalize(cross(vel, -z))."""
    axis = _cross_down(vel)
    axis = axis / (_norm(axis, keepdim=True) + 1e-8)
    return vspin[..., None] * 2 * np.pi * axis


def aero_force(vel, vspin, p: BallParams = DEFAULT_PARAMS):
    """Drag + Magnus force: drag = -kf*CD*|v|*v, lift = -kf*CL*|v|^2 *
    cross(vel_tan, vel_norm) with vel_tan = cross(vel_norm, -z) and CL's
    sign flipped for topspin."""
    speed = _norm(vel, keepdim=True)
    vel_norm = vel / (speed + 1e-8)
    vel_tan = _cross_down(vel_norm)
    cl = 1.0 / (2.0 + torch.abs(speed[..., 0] / (torch.abs(vspin) * p.spin_scale + 1e-6)))
    cl = torch.where(vspin > 0, -cl, cl)[..., None]
    force_drag = -p.kf * p.base_cd * speed * vel
    force_lift = -p.kf * cl * speed ** 2 * torch.linalg.cross(vel_tan, vel_norm, dim=-1)
    return force_drag + force_lift


class FlightResult(NamedTuple):
    traj: torch.Tensor          # (..., num_frames, 3) at 30 Hz
    bounce_pos: torch.Tensor    # (..., 3) first ground contact (0 if none)
    bounce_time: torch.Tensor   # (...,) seconds to first bounce
    bounce_frame: torch.Tensor  # (...,) int32 30 Hz frame index
    has_bounce: torch.Tensor    # (...,) bool
    pass_net: torch.Tensor      # (...,) bool: cleared the net at the y=0 crossing
    max_height_after_bounce: torch.Tensor
    final_pos: torch.Tensor
    final_vel: torch.Tensor
    final_vspin: torch.Tensor


def simulate_flight(pos0, vel0, vspin0, num_frames: int = 100, substeps: int = 4,
                    p: BallParams = DEFAULT_PARAMS) -> FlightResult:
    """Integrate ball flight for `num_frames` 30 Hz frames of `substeps`
    inner steps each, batched over leading dims. A bounce is a reflective
    impulse with COR + Coulomb friction on the tangential velocity; the spin
    flips to topspin at the first bounce."""
    dt = (1.0 / 30.0) / substeps
    batch = pos0.shape[:-1]
    dev, dt_ = pos0.device, pos0.dtype
    # made on the device: a host-built constant is a copy that syncs, and a
    # CUDA graph cannot hold it
    gvec = torch.zeros(3, dtype=dt_, device=dev)
    gvec.narrow(0, 2, 1).fill_(-p.gravity)
    pos, vel, vspin = pos0, vel0, vspin0
    has_bounce = torch.zeros(batch, dtype=torch.bool, device=dev)
    bounce_pos = torch.zeros(batch + (3,), dtype=dt_, device=dev)
    bounce_t = torch.zeros(batch, dtype=dt_, device=dev)
    crossed_net = torch.zeros(batch, dtype=torch.bool, device=dev)
    pass_net = torch.zeros(batch, dtype=torch.bool, device=dev)
    max_h = torch.zeros(batch, dtype=dt_, device=dev)
    t = torch.zeros(batch, dtype=dt_, device=dev)
    traj = []
    for _ in range(num_frames):
        for _ in range(substeps):
            f = aero_force(vel, vspin, p)
            acc = f / p.mass + gvec
            new_vel = vel + acc * dt
            new_pos = pos + new_vel * dt

            # net crossing: sign change of y this step
            y0, y1 = pos[..., 1], new_pos[..., 1]
            crossed = (y0 > 0) != (y1 > 0)
            w = torch.abs(y0) / (torch.abs(y0 - y1) + 1e-8)
            z_at_net = pos[..., 2] + w * (new_pos[..., 2] - pos[..., 2])
            first_cross = crossed & ~crossed_net
            pass_net = torch.where(first_cross, (z_at_net > court.NET_HEIGHT) & ~has_bounce,
                                   pass_net)
            crossed_net = crossed_net | crossed

            # ground bounce at z <= R: normal impulse + Coulomb tangential
            hit = new_pos[..., 2] <= p.radius
            vz = new_vel[..., 2]
            jn = (1.0 + p.restitution) * torch.abs(vz)
            vt = new_vel[..., :2]
            vt_norm = _norm(vt, keepdim=True)
            dvt = torch.minimum(p.friction * jn[..., None], vt_norm)
            vt_bounced = vt - dvt * vt / (vt_norm + 1e-8)
            bounced_vel = torch.cat([vt_bounced, (-p.restitution * vz)[..., None]], dim=-1)
            new_vel = torch.where(hit[..., None], bounced_vel, new_vel)
            z = new_pos[..., 2]
            new_pos = torch.cat([new_pos[..., :2],
                                 torch.where(hit, torch.clamp_min(z, p.radius), z)[..., None]],
                                dim=-1)
            first_hit = hit & ~has_bounce
            bounce_pos = torch.where(first_hit[..., None], new_pos, bounce_pos)
            bounce_t = torch.where(first_hit, t + dt, bounce_t)
            has_bounce = has_bounce | hit
            vspin = torch.where(first_hit, torch.abs(vspin), vspin)
            max_h = torch.where(has_bounce, torch.maximum(max_h, new_pos[..., 2]), max_h)
            t = t + dt
            pos, vel = new_pos, new_vel
        traj.append(pos)
    bounce_frame = torch.round(bounce_t * 30.0).to(torch.int32)
    return FlightResult(
        traj=torch.stack(traj, dim=-2), bounce_pos=bounce_pos, bounce_time=bounce_t,
        bounce_frame=torch.where(has_bounce, bounce_frame,
                                 torch.full_like(bounce_frame, num_frames - 1)),
        has_bounce=has_bounce, pass_net=pass_net, max_height_after_bounce=max_h,
        final_pos=pos, final_vel=vel, final_vspin=vspin)


# ---------------------------------------------------------------------------
# trajectory pool generator
# ---------------------------------------------------------------------------

class TennisBallGenerator:
    """Samples launch states from the opponent's side, simulates their
    flight and keeps the valid serves-in: past the net, bouncing inside the
    target box, rising above 1 m after the bounce. The pool lives on the
    device; `sample` and `sample_near` are gathers."""

    def __init__(self, cfg: Optional[dict] = None, num_candidates: int = 4096,
                 seed: int = 0, p: BallParams = DEFAULT_PARAMS, backend: str = "auto",
                 device=None):
        """backend: "torch" integrates the candidates with `simulate_flight`
        on `device`; "native" with the C++/OpenMP integrator on the host
        (``native/ballsim.cpp``), the pool then moved to `device`; "auto" is
        "torch". Both share the force model and draw the same launches, so
        their pools agree to float accumulation order. "native" raises when
        the library does not build or load: there is no fallback."""
        if backend not in ("auto", "torch", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        dev = resolve_device(device)
        cfg = cfg or {}
        self.p = p
        self.backend = "native" if backend == "native" else "torch"
        self.traj_length = int(cfg.get("ball_traj_length", 100))

        def vec(name, default):
            return torch.tensor(cfg.get(name, default), dtype=torch.float32)

        origin_min, origin_max = vec("origin_min", [-4.0, 12.0, 1.0]), vec("origin_max", [4.0, 13.0, 1.5])
        bounce_min, bounce_max = vec("bounce_min", [-3.0, -10.0, 0.0]), vec("bounce_max", [3.0, -7.0, 0.0])
        vel_range = cfg.get("vel_range", [28.0, 30.0])
        vspin_range = cfg.get("vspin_range", [5.0, 10.0])
        theta_range = cfg.get("theta_range", [5.0, 15.0])

        gen = torch.Generator().manual_seed(seed)
        n = num_candidates
        origin = torch.rand(n, 3, generator=gen) * (origin_max - origin_min) + origin_min
        bounce = torch.rand(n, 3, generator=gen) * (bounce_max - bounce_min) + bounce_min
        d = bounce[:, :2] - origin[:, :2]
        d = d / _norm(d, keepdim=True)
        speed = torch.rand(n, generator=gen) * (vel_range[1] - vel_range[0]) + vel_range[0]
        theta = torch.deg2rad(torch.rand(n, generator=gen) * (theta_range[1] - theta_range[0])
                              + theta_range[0])
        vspin = torch.rand(n, generator=gen) * (vspin_range[1] - vspin_range[0]) + vspin_range[0]
        vel = torch.stack([speed * torch.cos(theta) * d[:, 0],
                           speed * torch.cos(theta) * d[:, 1],
                           speed * torch.sin(theta)], dim=1)
        if self.backend == "native":
            from ..native import simulate_flight_native

            nat = simulate_flight_native(origin.numpy(), vel.numpy(), vspin.numpy(),
                                         num_frames=self.traj_length, params=p)
            res = FlightResult(*(torch.from_numpy(getattr(nat, f)) if f in nat._fields
                                 else None for f in FlightResult._fields))
        else:
            origin, vel, vspin = origin.to(dev), vel.to(dev), vspin.to(dev)
            res = simulate_flight(origin, vel, vspin, num_frames=self.traj_length, p=p)
        bmin, bmax = bounce_min.tolist(), bounce_max.tolist()
        valid = (res.pass_net & res.has_bounce
                 & (res.bounce_pos[:, 0] > bmin[0]) & (res.bounce_pos[:, 0] < bmax[0])
                 & (res.bounce_pos[:, 1] > bmin[1]) & (res.bounce_pos[:, 1] < bmax[1])
                 & (res.max_height_after_bounce > 1.0))
        idx = torch.nonzero(valid)[:, 0]
        if idx.numel() == 0:
            raise ValueError("no valid ball trajectories generated")
        self._set_pool(*(x[idx].to(dev) for x in (res.traj, origin, vel, vspin)))

    def _set_pool(self, traj, launch_pos, launch_vel, launch_vspin):
        self.traj_pool = traj
        self.launch_pos = launch_pos
        self.launch_vel = launch_vel
        self.launch_vspin = launch_vspin
        self.pool_size = int(traj.shape[0])
        self.traj_length = int(traj.shape[1])
        # launch-x sorted order for opponent-position-conditioned sampling
        self.x_order = torch.argsort(self.launch_x(), stable=True)

    @property
    def device(self) -> torch.device:
        return self.traj_pool.device

    @classmethod
    def from_arrays(cls, traj, launch_pos, launch_vel, launch_vspin,
                    p: BallParams = DEFAULT_PARAMS, device=None) -> "TennisBallGenerator":
        """A pool made elsewhere (numpy or tensors), e.g. the JAX package's."""
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self.p = p
        self.backend = "offline"

        def t(a):
            return torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

        self._set_pool(t(traj), t(launch_pos), t(launch_vel), t(launch_vspin))
        return self

    def save_npz(self, path: str) -> None:
        """Write the pool to a compressed `.npz` with the JAX package's keys
        (`traj`, `launch_pos`, `launch_vel`, `launch_vspin`)."""
        np.savez_compressed(
            path, traj=self.traj_pool.cpu().numpy(), launch_pos=self.launch_pos.cpu().numpy(),
            launch_vel=self.launch_vel.cpu().numpy(), launch_vspin=self.launch_vspin.cpu().numpy())

    @classmethod
    def from_npz(cls, path: str, p: BallParams = DEFAULT_PARAMS,
                 device=None) -> "TennisBallGenerator":
        """A pre-generated pool from a `.npz` that this class or the JAX
        package's `save_npz` wrote, on `device` (the card unless given)."""
        with np.load(path) as data:
            return cls.from_arrays(data["traj"], data["launch_pos"], data["launch_vel"],
                                   data["launch_vspin"], p=p, device=device)

    def launch_x(self):
        return self.launch_pos[:, 0]

    def _gather(self, idx):
        return (self.traj_pool[idx], self.launch_pos[idx], self.launch_vel[idx],
                self.launch_vspin[idx])

    def sample(self, n: int, generator: Optional[torch.Generator] = None, idx=None):
        """Random pool gather: (traj (n,T,3), launch_pos, launch_vel,
        launch_vspin). The pool indices are drawn from `generator` unless
        `idx` (n,) is given."""
        idx = self.pool_idx(n, generator) if idx is None else as_draw(idx, torch.long,
                                                                        self.device)
        return self._gather(idx)

    def pool_idx(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`sample`'s draw: n uniform pool rows."""
        return torch.randint(0, self.pool_size, (n,), generator=generator, device=self.device)

    def near_jitter(self, n: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`sample_near`'s draw: n offsets in [-win//2, win//2], win = pool/8."""
        win = max(1, self.pool_size // 8)
        return torch.randint(-win // 2, win // 2 + 1, (n,), generator=generator,
                             device=self.device)

    def sample_near(self, x, generator: Optional[torch.Generator] = None, jitter=None):
        """Opponent-position-conditioned gather among the pool entries whose
        launch x is closest to `x`: a jitter in [-win//2, win//2] around the
        sorted position, win = pool/8. The jitter is drawn from `generator`
        unless given."""
        xs = self.launch_pos[self.x_order, 0]
        pos = torch.searchsorted(xs, x.contiguous())
        jitter = self.near_jitter(x.shape[0], generator) if jitter is None \
            else as_draw(jitter, torch.long, self.device)
        idx = self.x_order[torch.clamp(pos + jitter, 0, self.pool_size - 1)]
        return self._gather(idx)


# ---------------------------------------------------------------------------
# estimator
# ---------------------------------------------------------------------------

def _state_to_launch(ball_states):
    """13-dim root state (pos3 quat4 lin3 ang3) -> (pos, vel, vspin)."""
    pos = ball_states[..., 0:3]
    vel = ball_states[..., 7:10]
    ang = ball_states[..., 10:13]
    vspin = _norm(ang) / (2 * np.pi)
    # recover the spin sign: topspin has angular velocity along cross(vel, -z)
    axis = _cross_down(vel)
    sign = torch.sign(torch.sum(ang * axis, dim=-1) + 1e-12)
    return pos, vel, vspin * sign


def pack_state(pos, vel, vspin):
    """(pos, vel, signed vspin) -> the 13-float ball state (pos3, identity
    quat xyzw, lin3, ang3)."""
    quat = torch.zeros(pos.shape[:-1] + (4,), dtype=pos.dtype, device=pos.device)
    quat[..., 3] = 1.0
    return torch.cat([pos, quat, vel, spin_vector(vel, vspin)], dim=-1)


def estimate_out(ball_states, num_frames: int = 120, substeps: int = 1,
                 p: BallParams = DEFAULT_PARAMS):
    """Outgoing-bounce estimate from post-contact ball states (N,13), by
    direct flight simulation. Returns (valid, bounce_pos (N,2), bounce_time
    (N,), max_height (N,)), the bounce zeroed where the ball does not clear
    the net."""
    pos, vel, vspin = _state_to_launch(ball_states)
    vel_xy = _norm(vel[..., :2])
    x_net = pos[..., 0] + vel[..., 0] * torch.abs(pos[..., 1] / (vel[..., 1] + 1e-8))
    valid = ((vel_xy > 10.0) & (vel[..., 2] > -5.0) & (vel[..., 2] < 10.0)
             & (pos[..., 2] < 3.0) & (x_net > -4.0) & (x_net < 4.0))
    res = simulate_flight(pos, vel, vspin, num_frames=num_frames, substeps=substeps, p=p)
    ok = res.pass_net & res.has_bounce
    bounce_pos = torch.where(ok[..., None], res.bounce_pos[..., :2], 0.0)
    bounce_time = torch.where(ok, res.bounce_time, 0.0)
    max_height = torch.amax(res.traj[..., 2], dim=-1)
    return valid, bounce_pos, bounce_time, max_height


def estimate_in(ball_states, traj_length: int = 100, p: BallParams = DEFAULT_PARAMS):
    """Dual-play hand-off: the opponent's outgoing 13-float ball states (N,13)
    mirrored through the net (x and y negated, positions and velocities) into
    this court's frame, and flown into the full incoming 30 Hz trajectory.
    Returns (traj (N,T,3), ball_states_in, ball_states_out), the last two
    packed again from (pos, vel, signed vspin)."""
    pos, vel, vspin = _state_to_launch(ball_states)
    mir = torch.tensor([-1.0, -1.0, 1.0], dtype=pos.dtype, device=pos.device)
    pos_in, vel_in = pos * mir, vel * mir
    res = simulate_flight(pos_in, vel_in, vspin, num_frames=traj_length, p=p)
    return res.traj, pack_state(pos_in, vel_in, vspin), pack_state(pos, vel, vspin)
