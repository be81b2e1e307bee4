"""Synthetic tennis-motion generator: rally cycles with real swing primitives
(PyTorch package's counterpart of ``vid2player3d_tpu/data/tennis_motion.py``).

A MotionVAE for tennis needs player motion whose latent space holds
run-to-the-ball and swing primitives, annotated with racket-hit frames.
Broadcast-video reconstructions are not shipped, so this module
*manufactures* a substitute: a procedural rig producing locomotion +
parameterized forehand/backhand swing cycles (ready → split-step → reach →
backswing → contact → follow-through → recover), annotated with exact hit
frames, in the video-dataset format (`mvae/dataset.py::write_video_dataset`
manifest + npy layout), and the same rallies as a `MotionLib` for the
low-level policy's fine-tune.

Rig design (host-side numpy, float64; runs once, never in the step path):
- world frame: court z-up, net at y=0, player on y<0, facing +y
  (root rotation = Rz(pi/2) @ R_BASE, `physics/asset.py`);
- skeleton: the same synthetic/real SMPL rest joints the simulator compiles
  (`physics/asset.py::build_humanoid_model`), so kinematic data and physics
  agree on bone lengths;
- the racket-arm is driven by an exact 2-bone IK to a keyframed racket-head
  path; the wrist local rotation is solved in closed form so the racket
  (grip frames, `tennis/racket.py`) passes EXACTLY through the contact
  point with the face toward the net at the annotated hit frame;
- the strike stance is placed so the contact point is reachable: root =
  contact - (racket offset of the contact pose), i.e. guaranteed-consistent
  hit annotations;
- gait: stride-phase-driven hip/knee/ankle cycling proportional to root
  speed, arms counter-swinging, idle ready-bounce between cycles.

Feature-space contract (what the MVAE/player consume, `tennis/player.py`):
joint_pos rows are [world root | root-relative joints 1..23, world axes],
rotations are SMPL-order local rotation matrices with the root row being the
global (world) root orientation.

Given the same `Skeleton` arrays and seed, `generate_rally_sequence` gives
the JAX package's sequence bit for bit: the same numpy draws in the same
order through the same float64 operations.

    python -m vid2player3d_torch.data.tennis_motion OUT_DIR [--num_sequences N]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import smpl as S
from ..physics.asset import _R_BASE
from ..tennis.racket import grip_arrays
from ..utils.runtime import resolve_device

# SMPL joint indices
_J = {n: i for i, n in enumerate(S.SMPL_BONE_ORDER_NAMES)}
PELVIS = _J["Pelvis"]
TORSO, SPINE, CHEST, NECK, HEAD = (_J["Torso"], _J["Spine"], _J["Chest"],
                                   _J["Neck"], _J["Head"])
L_HIP, L_KNEE, L_ANKLE, L_TOE = _J["L_Hip"], _J["L_Knee"], _J["L_Ankle"], _J["L_Toe"]
R_HIP, R_KNEE, R_ANKLE, R_TOE = _J["R_Hip"], _J["R_Knee"], _J["R_Ankle"], _J["R_Toe"]
L_COLLAR, L_SHOULDER, L_ELBOW, L_WRIST, L_HAND = (
    _J["L_Thorax"], _J["L_Shoulder"], _J["L_Elbow"], _J["L_Wrist"], _J["L_Hand"])
R_COLLAR, R_SHOULDER, R_ELBOW, R_WRIST, R_HAND = (
    _J["R_Thorax"], _J["R_Shoulder"], _J["R_Elbow"], _J["R_Wrist"], _J["R_Hand"])

_MIRROR_PERM = np.arange(24)
for _l, _r in ((L_HIP, R_HIP), (L_KNEE, R_KNEE), (L_ANKLE, R_ANKLE),
               (L_TOE, R_TOE), (L_COLLAR, R_COLLAR), (L_SHOULDER, R_SHOULDER),
               (L_ELBOW, R_ELBOW), (L_WRIST, R_WRIST), (L_HAND, R_HAND)):
    _MIRROR_PERM[_l], _MIRROR_PERM[_r] = _r, _l


# ---------------------------------------------------------------------------
# small numpy rotation helpers (vectorized over leading dims)
# ---------------------------------------------------------------------------

def _normalize(v, axis=-1):
    return v / (np.linalg.norm(v, axis=axis, keepdims=True) + 1e-9)


def rot_between(a, b):
    """Minimal rotation R with R @ a_hat = b_hat. a, b (...,3)."""
    a = _normalize(np.asarray(a, np.float64))
    b = _normalize(np.asarray(b, np.float64))
    v = np.cross(a, b)
    c = np.sum(a * b, axis=-1)
    s2 = np.sum(v * v, axis=-1)
    eye = np.broadcast_to(np.eye(3), a.shape[:-1] + (3, 3))
    K = np.zeros(a.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -v[..., 2], v[..., 1]
    K[..., 1, 0], K[..., 1, 2] = v[..., 2], -v[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -v[..., 1], v[..., 0]
    fac = np.where(s2 > 1e-12, (1.0 - c) / np.maximum(s2, 1e-12), 0.5)
    R = eye + K + fac[..., None, None] * (K @ K)
    # antiparallel: rotate pi about any perpendicular axis
    anti = c < -1.0 + 1e-8
    if np.any(anti):
        perp = np.cross(a, np.broadcast_to([1.0, 0.0, 0.0], a.shape))
        bad = np.linalg.norm(perp, axis=-1) < 1e-6
        perp[bad] = np.cross(a[bad], [0.0, 1.0, 0.0])
        perp = _normalize(perp)
        R_pi = 2.0 * perp[..., :, None] * perp[..., None, :] - np.eye(3)
        R = np.where(anti[..., None, None], R_pi, R)
    return R


def rot_axis(axis, theta):
    """Rotation about a fixed axis ('x'|'y'|'z') by theta (...,)."""
    theta = np.asarray(theta, np.float64)
    c, s = np.cos(theta), np.sin(theta)
    R = np.zeros(theta.shape + (3, 3))
    i = {"x": 0, "y": 1, "z": 2}[axis]
    j, k = (i + 1) % 3, (i + 2) % 3
    R[..., i, i] = 1.0
    R[..., j, j], R[..., k, k] = c, c
    R[..., j, k], R[..., k, j] = -s, s
    return R


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _keyframe_interp(times, keys, t):
    """Catmull-Rom (cubic Hermite, finite-difference tangents) interpolation
    on non-uniform knots: C1 through interior keys, so a swing keyframed
    load→CONTACT→follow-through moves at full speed THROUGH the contact
    instead of easing to a stop at it. times (K,) ascending, keys (K, D),
    t (T,) -> (T, D)."""
    times = np.asarray(times, np.float64)
    keys = np.asarray(keys, np.float64)
    K = len(times)
    # knot tangents: central differences, one-sided at the ends
    m = np.zeros_like(keys)
    m[1:-1] = (keys[2:] - keys[:-2]) / (times[2:] - times[:-2])[:, None]
    m[0] = (keys[1] - keys[0]) / max(times[1] - times[0], 1e-9)
    m[-1] = (keys[-1] - keys[-2]) / max(times[-1] - times[-2], 1e-9)

    idx = np.clip(np.searchsorted(times, t, side="right") - 1, 0, K - 2)
    t0, t1 = times[idx], times[idx + 1]
    h = np.maximum(t1 - t0, 1e-9)
    s = np.clip((t - t0) / h, 0.0, 1.0)[:, None]
    h00 = 2 * s**3 - 3 * s**2 + 1
    h10 = s**3 - 2 * s**2 + s
    h01 = -2 * s**3 + 3 * s**2
    h11 = s**3 - s**2
    out = (h00 * keys[idx] + h10 * h[:, None] * m[idx]
           + h01 * keys[idx + 1] + h11 * h[:, None] * m[idx + 1])
    out[t <= times[0]] = keys[0]
    out[t >= times[-1]] = keys[-1]
    return out


def two_bone_ik(s, w, L1, L2, hint):
    """Analytic 2-bone IK: shoulder s (T,3), wrist target w (T,3), bone
    lengths L1/L2, elbow-bend hint direction (T,3). Returns elbow pos (T,3)
    and the (possibly clamped) wrist position actually reached."""
    d = w - s
    dl = np.linalg.norm(d, axis=-1)
    dl_c = np.clip(dl, abs(L1 - L2) + 1e-4, L1 + L2 - 1e-4)
    d_hat = _normalize(d)
    w = s + d_hat * dl_c[:, None]
    cos_a = (L1 * L1 + dl_c * dl_c - L2 * L2) / (2.0 * L1 * dl_c)
    proj = s + d_hat * (L1 * cos_a)[:, None]
    r = L1 * np.sqrt(np.maximum(1.0 - cos_a * cos_a, 0.0))
    hperp = hint - np.sum(hint * d_hat, -1, keepdims=True) * d_hat
    small = np.linalg.norm(hperp, axis=-1) < 1e-6
    fallback = np.cross(d_hat, np.broadcast_to([0.0, 0.0, 1.0], d_hat.shape))
    hperp[small] = fallback[small]
    e = proj + _normalize(hperp) * r[:, None]
    return e, w


# ---------------------------------------------------------------------------
# skeleton
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Skeleton:
    rest: np.ndarray      # (24,3) SMPL-frame rest joints
    offsets: np.ndarray   # (24,3) parent-relative, SMPL frame
    parents: np.ndarray

    @classmethod
    def from_smpl(cls, smpl_model=None, betas=None):
        smpl_model = smpl_model or S.make_synthetic_smpl()
        betas = np.zeros(10, np.float32) if betas is None else betas
        betas = torch.from_numpy(np.asarray(betas, np.float32)[None])
        rest = S.rest_joints(smpl_model, betas).numpy()[0]
        off = rest - np.where((S.SMPL_PARENTS >= 0)[:, None],
                              rest[np.maximum(S.SMPL_PARENTS, 0)], 0.0)
        off[0] = 0.0
        return cls(rest=rest.astype(np.float64), offsets=off.astype(np.float64),
                   parents=S.SMPL_PARENTS)

    def fk(self, rotmats, root_pos):
        """rotmats (T,24,3,3) local (root global), root_pos (T,3) ->
        world joints (T,24,3), world rotations (T,24,3,3)."""
        T = rotmats.shape[0]
        Rw = np.zeros((T, 24, 3, 3))
        pw = np.zeros((T, 24, 3))
        Rw[:, 0] = rotmats[:, 0]
        pw[:, 0] = root_pos
        for j in range(1, 24):
            p = int(self.parents[j])
            pw[:, j] = pw[:, p] + np.einsum("tab,b->ta", Rw[:, p],
                                            self.offsets[j])
            Rw[:, j] = Rw[:, p] @ rotmats[:, j]
        return pw, Rw


# world root orientation of an upright player facing the net (+y):
# body y-up -> world z-up (base rot) then yaw so the SMPL facing axis (+z,
# mapped to world +x by R_BASE) points at +y
R_ROOT0 = rot_axis("z", np.pi / 2)[()] @ _R_BASE.astype(np.float64)


# ---------------------------------------------------------------------------
# swing / cycle parameterization
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CycleParams:
    """One rally cycle: opponent hit -> my contact -> next opponent hit."""
    n_in: int             # frames opponent-hit -> my contact
    n_rec: int            # frames my contact -> next opponent hit
    contact: np.ndarray   # (3,) world contact point
    swing: int            # 1 fh, 2 bh (SMPL wrist-x convention)
    home: np.ndarray      # (2,) recover-to position


def sample_cycles(rng: np.random.Generator, n_cycles: int,
                  court_x: float = 3.2) -> List[CycleParams]:
    out = []
    home = np.array([rng.uniform(-0.8, 0.8), rng.uniform(-13.2, -12.2)])
    for _ in range(n_cycles):
        cx = rng.uniform(-court_x, court_x)
        cy = rng.uniform(-13.6, -11.4)
        cz = rng.uniform(0.7, 1.6)
        # swing type follows the contact side relative to home with a little
        # stochastic overlap near the body (players run around backhands)
        p_fh = np.clip(0.5 + 0.45 * np.tanh(1.5 * (cx - home[0])), 0.05, 0.95)
        swing = 1 if rng.random() < p_fh else 2
        out.append(CycleParams(
            n_in=int(rng.integers(58, 78)),
            n_rec=int(rng.integers(55, 80)),
            contact=np.array([cx, cy, cz]),
            swing=swing,
            home=home + rng.uniform(-0.3, 0.3, 2)))
    return out


# racket-face elevation range at contact (z of the unit aim direction):
# chosen so a well-timed strike clears the net
# AND Magnus topspin brings it down inside the court
AIM_ELEVATION = (0.20, 0.36)


def _contact_frames(swing: int, righthand: bool, rng,
                    contact_x: float = 0.0,
                    contact_z: float = 1.1) -> Tuple[np.ndarray, np.ndarray]:
    """Racket dir/normal at contact (world, right-handed convention —
    mirrored later for lefties): fh extends to +x, bh to -x; face aimed at
    the net, slightly open, biased back toward the court center from wide
    contact positions."""
    side = 1.0 if swing == 1 else -1.0
    # The face NORMAL is chosen first and exactly — it is the aim of the
    # shot under the env's restitution reflection (`envs/tennis.py::
    # _ball_physics`): slightly OPEN (tilted up) so a descending incoming
    # ball is lifted over the net, biased back toward the court center from
    # wide contacts. The shaft direction d is then orthogonalized against
    # it (lateral-ish, fh +x / bh -x) — orthogonalizing the other way
    # around used to bleed ~0.1 off the realized normal_z and put 40% of
    # well-struck returns into the net.
    aim_x = rng.uniform(-0.12, 0.12) - 0.06 * contact_x
    aim_z = rng.uniform(*AIM_ELEVATION)
    n = _normalize(np.array([aim_x, 1.0, aim_z]))
    d0 = np.array([side, rng.uniform(-0.05, 0.15), rng.uniform(-0.1, 0.2)])
    d = _normalize(d0 - np.sum(d0 * n) * n)
    return d, n


class _ArmPath:
    """Keyframed racket path for one cycle, in strike-stance-root-relative
    world coordinates. Times are fractions of the full cycle [0, 1] with the
    contact at `tc` (= n_in / (n_in + n_rec))."""

    def __init__(self, cp: CycleParams, tc: float, reach: float,
                 rng: np.random.Generator, fps: float = 30.0,
                 speed: float = 1.0):
        fh = cp.swing == 1
        side = 1.0 if fh else -1.0
        cz = cp.contact[2]
        d_c, n_c = _contact_frames(cp.swing, True, rng,
                                   contact_x=float(cp.contact[0]),
                                   contact_z=float(cp.contact[2]))
        wrist_c = -d_c * reach          # contact-relative wrist position
        j = lambda s: rng.uniform(-s, s)

        # wrist positions RELATIVE TO THE CONTACT POINT (so the path passes
        # exactly through it); ready positions relative to the root are
        # handled by the caller blending with the ready pose
        # keys: ready | backswing start | loaded | CONTACT | early/late
        # follow-through | settled.
        #
        # The forward swing (loaded -> contact -> early follow-through) is
        # keyed in SECONDS, not cycle fractions: a real stroke accelerates
        # through contact in ~0.15 s regardless of how long the incoming
        # ball flies, and with Catmull-Rom tangents the speed at the contact
        # knot is |P_follow_early - P_load| / (t_fe - t_load) — the distance
        # and window below set the racket head to ~10-18 m/s at contact
        # (broadcast-video stroke speeds), vs ~3 m/s when these knots were
        # fractions of a 4-5 s cycle (swings keyed so never cleared the net).
        T_s = (cp.n_in + cp.n_rec) / fps              # cycle length, seconds
        sp = float(speed)
        dt_back = rng.uniform(0.42, 0.58) / T_s
        dt_load = (rng.uniform(0.13, 0.18) / sp) / T_s
        dt_fe = (rng.uniform(0.07, 0.10) / sp) / T_s
        dt_fol = rng.uniform(0.26, 0.34) / T_s
        t_back = max(tc - dt_back, 0.35 * tc)
        t_load = max(tc - dt_load, 0.5 * (t_back + tc))
        t_fe = min(tc + dt_fe, 1.0 - 0.02)
        t_fol = min(tc + dt_fol, 0.5 * (t_fe + 1.0))
        self.t_keys = np.array([0.0, t_back, t_load, tc, t_fe, t_fol, 1.0])
        back = np.array([side * (0.5 + j(0.1)) - d_c[0] * reach,
                         -1.05 * sp + j(0.15), cz * 0.4 + j(0.1) - 0.4])
        load = np.array([side * (0.55 + j(0.1)) - d_c[0] * reach,
                         -(0.95 * sp) + j(0.1), cz * 0.2 - 0.5 + j(0.1)])
        follow = np.array([-side * (0.5 + j(0.15)), 0.75 + 0.35 * sp + j(0.15),
                           0.4 + j(0.15)])
        settle = np.array([-side * 0.2, 0.35, -0.1])
        ready = np.array([side * 0.3, 0.3, cz * 0.0 - 0.2])
        self.wrist_keys = np.stack([
            ready, back, load, wrist_c, follow * 0.7 + wrist_c * 0.3,
            follow, settle])

        # racket dir/normal keys (unit, re-orthogonalized after interp)
        d_back = _normalize(np.array([side * 0.7, -0.7, -0.15]))
        n_back = _normalize(np.array([side * -0.4, 0.6, 0.7]))
        d_fol = _normalize(np.array([-side * 0.8, 0.5, 0.4]))
        n_fol = _normalize(np.array([side * 0.3, 0.7, -0.6]))
        d_rdy = _normalize(np.array([side * 0.5, 0.6, -0.6]))
        n_rdy = _normalize(np.array([side * -0.6, 0.4, 0.6]))
        self.dir_keys = np.stack([d_rdy, d_back, d_back, d_c,
                                  _normalize(d_c + d_fol), d_fol, d_rdy])
        self.nrm_keys = np.stack([n_rdy, n_back, n_back, n_c,
                                  _normalize(n_c + n_fol), n_fol, n_rdy])

    def eval(self, t: np.ndarray):
        w = _keyframe_interp(self.t_keys, self.wrist_keys, t)
        d = _normalize(_keyframe_interp(self.t_keys, self.dir_keys, t))
        n = _keyframe_interp(self.t_keys, self.nrm_keys, t)
        n = _normalize(n - np.sum(n * d, -1, keepdims=True) * d)
        return w, d, n


# ---------------------------------------------------------------------------
# sequence generation
# ---------------------------------------------------------------------------

def generate_rally_sequence(rng: np.random.Generator,
                            skel: Optional[Skeleton] = None,
                            n_cycles: int = 6,
                            fps: float = 30.0,
                            noise: float = 0.03,
                            swing_speed: float = 1.0
                            ) -> Dict:
    """One fg-player rally: returns {joint_pos (T,24,3), joint_rotmat
    (T,24,3,3), hits [(frame, is_fg), ...]} in the video-dataset convention
    (right-handed; mirror with `mirror_sequence` for left-handed players)."""
    skel = skel or Skeleton.from_smpl()
    cycles = sample_cycles(rng, n_cycles)
    reach = grip_arrays("eastern")[2]

    # ---- timeline ----------------------------------------------------------
    bounds = np.cumsum([0] + [c.n_in + c.n_rec for c in cycles])
    T = int(bounds[-1]) + 2
    hits: List[Tuple[int, bool]] = []
    for c, b in zip(cycles, bounds[:-1]):
        hits.append((int(b) + 1, False))           # opponent hit
        hits.append((int(b) + 1 + c.n_in, True))   # my contact
    hits.append((T - 1, False))                    # closing opponent hit

    # ---- root path + stance, arm targets ----------------------------------
    # compute per-cycle strike stance so the contact is reachable: stance =
    # contact - (typical contact-pose racket offset from root)
    root_xy_keys = [np.array([cycles[0].home[0], cycles[0].home[1]])]
    t_xy_keys = [0.0]
    arm_paths = []
    # arm geometry for reachable stance placement
    L1 = float(np.linalg.norm(skel.offsets[R_ELBOW]))
    L2 = float(np.linalg.norm(skel.offsets[R_WRIST]))
    sho_off_w = R_ROOT0 @ skel.rest[R_SHOULDER]   # root->shoulder, world
    for c, b in zip(cycles, bounds[:-1]):
        tc_local = c.n_in / (c.n_in + c.n_rec)
        ap = _ArmPath(c, tc_local, reach, rng, fps=fps, speed=swing_speed)
        arm_paths.append(ap)
        side = 1.0 if c.swing == 1 else -1.0
        # place the root so the contact wrist target sits at ~93% of full
        # arm extension from the shoulder — guarantees the 2-bone IK reaches
        # it and the annotated hit frame really has the racket on the ball
        wrist_c = c.contact + ap.wrist_keys[3]     # world wrist at contact
        r_arm = rng.uniform(0.88, 0.96) * (L1 + L2)
        z_sho = 0.91 - 0.03 + sho_off_w[2]         # crouched shoulder height
        z_gap = z_sho - wrist_c[2]
        horiz = np.sqrt(max(r_arm ** 2 - z_gap ** 2, 0.12 ** 2))
        beta = np.deg2rad(rng.uniform(15.0, 40.0))  # behind-the-ball angle
        h_dir = np.array([-side * np.cos(beta), -np.sin(beta)])
        sho_xy = wrist_c[:2] + horiz * h_dir
        stance = sho_xy - sho_off_w[:2]
        t0, t1 = b + 1, b + 1 + c.n_in
        # arrive before the swing window opens (phase 2.0 rad ~ 64% of the
        # incoming interval — the classifier latches there), hold through
        # the swing, then recover home
        t_xy_keys += [ (t0 + 0.30 * c.n_in), (t0 + 0.60 * c.n_in),
                       (t1 + 4.0), (t1 + 0.75 * c.n_rec) ]
        root_xy_keys += [None, stance, stance + [0.0, 0.05], c.home]
    # fill the "hold previous" keys (None) with the prior key
    for i, kv in enumerate(root_xy_keys):
        if kv is None:
            root_xy_keys[i] = root_xy_keys[i - 1]
    t_grid = np.arange(T, dtype=np.float64)
    root_xy = _keyframe_interp(np.asarray(t_xy_keys, np.float64),
                               np.stack(root_xy_keys), t_grid)

    # root height: base ~0.91 with speed-dependent dip + gait bounce
    root_v = np.zeros((T, 2))
    root_v[1:] = root_xy[1:] - root_xy[:-1]
    speed = np.linalg.norm(root_v, axis=-1) * fps          # m/s
    stride_phase = np.cumsum(speed / fps) / rng.uniform(0.85, 1.1) * np.pi
    bounce = 0.018 * np.sin(2.0 * stride_phase)
    crouch = np.clip(speed, 0, 4.0) * 0.012
    root_z = 0.91 - crouch + bounce + noise * 0.2 * _smooth_noise(rng, T)
    root_pos = np.concatenate([root_xy, root_z[:, None]], -1)

    # ---- per-frame joint rotations -----------------------------------------
    rot = np.broadcast_to(np.eye(3), (T, 24, 3, 3)).copy()

    # root yaw: face the net, lean into travel a touch
    yaw = 0.12 * np.clip(root_v[:, 0] * fps / 3.0, -1, 1) \
        + noise * _smooth_noise(rng, T)
    rot[:, 0] = rot_axis("z", yaw) @ R_ROOT0

    # torso twist for the swing (about body y = world z when upright):
    # wound back during the backswing, released through contact
    twist = np.zeros(T)
    for c, b, ap in zip(cycles, bounds[:-1], arm_paths):
        L = c.n_in + c.n_rec
        tl = (t_grid - (b + 1)) / L
        side = 1.0 if c.swing == 1 else -1.0
        tw_keys = np.array([[0.0], [0.0], [-0.55 * side], [0.35 * side],
                            [0.5 * side], [0.1 * side], [0.0]])
        seg = _keyframe_interp(ap.t_keys, tw_keys, np.clip(tl, 0, 1))[:, 0]
        m = (tl >= 0) & (tl <= 1)
        twist[m] = seg[m]
    for jj, frac in ((TORSO, 0.35), (SPINE, 0.35), (CHEST, 0.30)):
        rot[:, jj] = rot_axis("y", twist * frac)
    # slight forward hunch (about body x: negative pitches the spine forward)
    hunch = -0.08 - 0.04 * np.clip(speed / 4.0, 0, 1)
    rot[:, SPINE] = rot[:, SPINE] @ rot_axis("x", hunch)

    # ---- legs: stride-driven gait ------------------------------------------
    amp = np.clip(speed / 4.0, 0.06, 1.0) * 0.5
    for hip, knee, ankle, ph in ((L_HIP, L_KNEE, L_ANKLE, 0.0),
                                 (R_HIP, R_KNEE, R_ANKLE, np.pi)):
        sw = np.sin(stride_phase + ph)
        hip_pitch = amp * sw
        knee_flex = np.clip(amp * (np.cos(stride_phase + ph) + 0.6), 0.12,
                            1.2)
        # thigh points -y in body frame; rotating about +x swings it
        # backward, so forward swing = -pitch; knee bends backward = +x
        rot[:, hip] = rot_axis("x", -hip_pitch)
        rot[:, knee] = rot_axis("x", knee_flex)
        rot[:, ankle] = rot_axis("x", -0.5 * knee_flex + 0.3 * hip_pitch)

    # ---- racket arm: 2-bone IK to the keyframed path ------------------------
    # world wrist targets: contact-relative path + per-frame blend between
    # the moving root (ready/locomotion) and the frozen contact anchor
    wrist_t = np.zeros((T, 3))
    dir_t = np.zeros((T, 3))
    nrm_t = np.zeros((T, 3))
    wrist_t[:] = root_pos + (R_ROOT0 @ np.array([-0.35, 0.4, -0.25]))
    dir_t[:] = _normalize(np.array([0.6, 0.5, -0.6]))
    nrm_t[:] = _normalize(np.array([-0.5, 0.5, 0.6]))
    for c, b, ap in zip(cycles, bounds[:-1], arm_paths):
        L = c.n_in + c.n_rec
        tl = (t_grid - (b + 1)) / L
        m = (tl >= 0) & (tl <= 1)
        w_rel, d, n = ap.eval(tl[m])
        # anchor: the path is contact-relative during the swing window and
        # root-relative otherwise; blend by proximity to the contact time
        tc = c.n_in / L
        w_anchor = _smoothstep((tl[m] - (tc - 0.36)) / 0.18) \
            * (1.0 - _smoothstep((tl[m] - (tc + 0.10)) / 0.15))
        anchor = c.contact[None] * w_anchor[:, None] \
            + (root_pos[m] + np.array([0.0, 0.35, 0.15])) \
            * (1.0 - w_anchor[:, None])
        wrist_t[m] = anchor + w_rel
        dir_t[m], nrm_t[m] = d, n

    _solve_arm(skel, rot, root_pos, wrist_t, dir_t, nrm_t, right=True)

    # off arm: relaxed counter-pose with a two-hand-ish lift during backhands
    off_wrist = root_pos + np.einsum("ab,tb->ta",
                                     R_ROOT0, np.stack([
                                         0.28 + 0.1 * np.sin(stride_phase),
                                         np.full(T, 0.25),
                                         np.full(T, -0.25)], -1))
    _solve_arm(skel, rot, root_pos, off_wrist, None, None, right=False)

    # smooth everything a touch + tiny angle noise for diversity
    if noise > 0:
        rot[:, 1:] = rot[:, 1:] @ rot_axis(
            "y", noise * _smooth_noise(rng, (T, 23)))

    # ---- FK -> dataset arrays ----------------------------------------------
    pw, _ = skel.fk(rot, root_pos)
    jp = np.concatenate([root_pos[:, None],
                         pw[:, 1:] - root_pos[:, None]], axis=1)
    return {"joint_pos": jp.astype(np.float32),
            "joint_rotmat": rot.astype(np.float32),
            "hits": hits}


def _solve_arm(skel: Skeleton, rot, root_pos, wrist_t, dir_t, nrm_t,
               right: bool):
    """In-place: shoulder/elbow from 2-bone IK toward wrist_t; wrist local
    rotation solved exactly from the racket dir/normal targets (None for the
    off arm -> neutral wrist)."""
    COLLAR, SHO, ELB, WRI = (R_COLLAR, R_SHOULDER, R_ELBOW, R_WRIST) if right \
        else (L_COLLAR, L_SHOULDER, L_ELBOW, L_WRIST)
    T = rot.shape[0]
    # world transforms down to the collar with current rot
    pw, Rw = skel.fk(rot, root_pos)
    s = pw[:, SHO]
    L1 = float(np.linalg.norm(skel.offsets[ELB]))
    L2 = float(np.linalg.norm(skel.offsets[WRI]))
    hint = np.tile(np.array([0.0, -0.6, -0.8]), (T, 1))   # elbow back/down
    e, w = two_bone_ik(s, wrist_t, L1, L2, hint)

    P = Rw[:, COLLAR]
    u_local = np.einsum("tba,tb->ta", P, _normalize(e - s))
    Lsho = rot_between(np.broadcast_to(_normalize(skel.offsets[ELB]),
                                       (T, 3)), u_local)
    rot[:, SHO] = Lsho
    R_sho_w = P @ Lsho
    f_local = np.einsum("tba,tb->ta", R_sho_w, _normalize(w - e))
    Lelb = rot_between(np.broadcast_to(_normalize(skel.offsets[WRI]),
                                       (T, 3)), f_local)
    rot[:, ELB] = Lelb
    R_elb_w = R_sho_w @ Lelb
    if dir_t is None:
        rot[:, WRI] = np.eye(3)
        return
    # exact wrist: grip dir_c=(-1,0,0), normal_c=(0,1,0) (eastern, the
    # right-handed canonical frame) -> W_target columns [-d | n | -d x n];
    # re-orthonormalize so W_tar is a proper rotation even for targets the
    # caller didn't Gram-Schmidt
    d = _normalize(dir_t)
    n = nrm_t - np.sum(nrm_t * d, -1, keepdims=True) * d
    n = _normalize(n)
    x_img = -d
    z_img = np.cross(x_img, n)
    W_tar = np.stack([x_img, n, z_img], axis=-1)
    rot[:, WRI] = np.einsum("tba,tbc->tac", R_elb_w, W_tar)


def _smooth_noise(rng, shape, n_waves: int = 3):
    """Sum of random low-frequency sinusoids along axis 0, unit-ish scale."""
    if isinstance(shape, int):
        shape = (shape,)
    T = shape[0]
    t = np.arange(T) / T
    out = np.zeros(shape)
    for _ in range(n_waves):
        f = rng.uniform(0.5, 3.0, shape[1:])
        ph = rng.uniform(0, 2 * np.pi, shape[1:])
        out += np.sin(2 * np.pi * f * t.reshape((T,) + (1,) * (len(shape) - 1))
                      + ph)
    return out / n_waves


def mirror_sequence(seq: Dict) -> Dict:
    """x-mirror for left-handed players: world x flips, left/right joints
    swap, rotations conjugate by diag(-1,1,1) (det stays +1 after the
    swap+conjugation — the standard motion-capture mirror)."""
    M = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    jp = seq["joint_pos"][:, _MIRROR_PERM].copy()
    jp[..., 0] *= -1.0
    # keep root row first (pelvis maps to itself)
    rot = seq["joint_rotmat"][:, _MIRROR_PERM]
    rot = M[None, None] @ rot @ M[None, None]
    return {"joint_pos": jp.astype(np.float32),
            "joint_rotmat": rot.astype(np.float32),
            "hits": list(seq["hits"])}


# ---------------------------------------------------------------------------
# dataset emission (video-dataset format)
# ---------------------------------------------------------------------------

def measure_head_speed(seq: Dict, skel: Optional[Skeleton] = None,
                       fps: float = 30.0, righthand: bool = True):
    """Racket-head speed (m/s, central difference) at each annotated fg hit
    frame of a generated sequence — the 'do the synthetic swings strike?'
    diagnostic. Head = wrist + dir * reach with the canonical grip dir
    mapped to the wrist frame's -x column (`_solve_arm`)."""
    skel = skel or Skeleton.from_smpl()
    reach = grip_arrays("eastern")[2]
    rot = seq["joint_rotmat"].astype(np.float64)
    root = seq["joint_pos"][:, 0].astype(np.float64)
    pw, Rw = skel.fk(rot, root)
    wri = R_WRIST if righthand else L_WRIST
    sgn = 1.0 if righthand else -1.0
    head = pw[:, wri] - sgn * Rw[:, wri, :, 0] * reach
    vel = np.zeros_like(head)
    vel[1:-1] = (head[2:] - head[:-2]) * (0.5 * fps)
    speeds = np.linalg.norm(vel, axis=-1)
    hit_f = np.array([f for f, fg in seq["hits"] if fg], int)
    hit_f = hit_f[(hit_f > 0) & (hit_f < len(speeds) - 1)]
    return speeds[hit_f], speeds


def generate_tennis_dataset(out_dir: str, num_sequences: int = 64,
                            cycles_per_seq: int = 6, seed: int = 0,
                            player: str = "Federer",
                            righthand: bool = True,
                            smpl_model=None,
                            swing_speed: float = 1.0) -> str:
    """Write a synthetic rally dataset in the video-dataset
    layout (manifest + flat npys + hit keyframes; `mvae/dataset.py::
    load_video_dataset`). One manifest video per sequence, all fg-side."""
    from ..mvae.dataset import write_video_dataset

    rng = np.random.default_rng(seed)
    skel = Skeleton.from_smpl(smpl_model)
    videos = []
    for i in range(num_sequences):
        seq = generate_rally_sequence(rng, skel, n_cycles=cycles_per_seq,
                                      swing_speed=swing_speed)
        if not righthand:
            seq = mirror_sequence(seq)
        T = seq["joint_pos"].shape[0]
        videos.append({
            "name": f"synth_{player.lower()}_{i:04d}",
            "background": "synthetic",
            "gender": "m",
            "is_orig": True,
            "points_annotation": [{
                "keyframes": [{"fid": f, "fg": bool(fg)}
                              for f, fg in seq["hits"]]}],
            "sequences": {"fg": [{
                "player": player,
                "handness": "right" if righthand else "left",
                "beta": [0.0] * 10,
                "point_idx": 0,
                "start": 0,
                "arrays": {"joint_pos": seq["joint_pos"],
                           "joint_rotmat": seq["joint_rotmat"],
                           "valid": np.ones(T, bool)},
            }], "bg": []},
        })
    write_video_dataset(out_dir, videos)
    return out_dir


def tennis_motion_lib(num_sequences: int = 32, cycles_per_seq: int = 5,
                      seed: int = 0, righthand: bool = True,
                      smpl_model=None, out_path: Optional[str] = None,
                      swing_speed: float = 1.0, device=None):
    """Generated rallies → `MotionLib` on `device` (the card unless given)
    for LOW-LEVEL imitation fine-tuning: π_low fine-tunes on the same
    motion distribution the MVAE decodes, so it tracks swings it will
    actually be asked to track. The conversion runs on the host in float32."""
    from ..core import rot as R
    from .amass import build_motion_lib, convert_amass_sequence

    device = resolve_device(device)
    smpl_model = smpl_model or S.make_synthetic_smpl()
    skel = Skeleton.from_smpl(smpl_model)
    rng = np.random.default_rng(seed)
    entries = []
    betas = np.zeros(10, np.float32)
    j0 = skel.rest[0]
    for _ in range(num_sequences):
        seq = generate_rally_sequence(rng, skel, n_cycles=cycles_per_seq,
                                      swing_speed=swing_speed)
        if not righthand:
            seq = mirror_sequence(seq)
        rot = seq["joint_rotmat"].astype(np.float64)
        pos = seq["joint_pos"]
        # pad to 128-frame buckets by repeating the final frame (a short
        # standing hold at the end of each rally), as the JAX package does
        # to bound its recompiles: kept so that both packages build the
        # same library from the same seed
        T = rot.shape[0]
        T_pad = ((T + 127) // 128) * 128
        if T_pad != T:
            rot = np.concatenate(
                [rot, np.repeat(rot[-1:], T_pad - T, axis=0)], axis=0)
            pos = np.concatenate(
                [pos, np.repeat(pos[-1:], T_pad - T, axis=0)], axis=0)
        seq = dict(seq, joint_rotmat=rot, joint_pos=pos)
        T = T_pad
        rot32 = torch.from_numpy(rot.reshape(-1, 3, 3).astype(np.float32))
        pose_aa = R.rotmat_to_angle_axis(rot32).numpy().reshape(T, 72)
        trans = seq["joint_pos"][:, 0] - j0[None].astype(np.float32)
        entries.append(convert_amass_sequence(
            smpl_model, pose_aa, trans, betas, fps=30.0))
    lib = build_motion_lib(entries, device=device)
    if out_path:
        lib.save(out_path)
    return lib


def _main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Generate a synthetic tennis-motion dataset "
                    "(video-dataset layout) for MVAE training")
    p.add_argument("out_dir")
    p.add_argument("--num_sequences", type=int, default=96)
    p.add_argument("--cycles_per_seq", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--player", default="Federer")
    p.add_argument("--lefthand", action="store_true")
    p.add_argument("--swing_speed", type=float, default=1.0,
                   help="forward-swing speed scale (1.0 ~ 10-18 m/s racket "
                        "head at contact)")
    a = p.parse_args(argv)
    out = generate_tennis_dataset(
        a.out_dir, num_sequences=a.num_sequences,
        cycles_per_seq=a.cycles_per_seq, seed=a.seed, player=a.player,
        righthand=not a.lefthand, swing_speed=a.swing_speed)
    # report the contact-speed diagnostic on a fresh probe sequence
    rng = np.random.default_rng(a.seed + 977)
    skel = Skeleton.from_smpl()
    hs = np.concatenate([
        measure_head_speed(generate_rally_sequence(
            rng, skel, swing_speed=a.swing_speed), skel)[0]
        for _ in range(8)])
    print(f"wrote {out}  head_speed@contact m/s: "
          f"mean={hs.mean():.1f} p50={np.median(hs):.1f} "
          f"p10={np.percentile(hs, 10):.1f} p90={np.percentile(hs, 90):.1f}")


if __name__ == "__main__":
    _main()
