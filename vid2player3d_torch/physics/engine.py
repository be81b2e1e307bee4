"""Batched articulated rigid-body dynamics (Featherstone ABA) in PyTorch.

Counterpart of ``vid2player3d_tpu/physics/engine.py``: the functions
    control_step(model, state, pd_targets, ...) -> state   (substeps at control_dt)
    substep(model, state, pd_targets, ..., dt, fixed_base) -> state
batched over envs and vectorized over the static 24-body kinematic tree.

Layout: the inner math runs on the SoA core (``physics/soa.py``) over
**level-batched slabs** — every vector/matrix is a tensor whose leading axes
are its components and whose last two axes are (bodies of one tree level,
envs), env axis minor. Bodies at the same tree depth are processed together
(8 levels instead of 23 bodies for SMPL-24); the level index tensors are
built once with the model (``model.Topology``).

Pipeline per substep:
  1. FK → body world poses/velocities (per-level chain)
  2. penalty ground contacts (+ self-collision pairs) → dense wrench slabs
  3. stable-PD proportional joint torques in exp-map coordinates
  4. ABA forward dynamics in 3x3 block form, damping implicit
  5. semi-implicit Euler integrate (quaternion joints, body-frame twists)

The JAX package scans the substeps under ``lax.scan``; here they are a
Python loop, with the model unpack hoisted out of it.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core import quat as Q
from . import soa
from .model import ArticulationModel, ArticulationState, ContactParams, GRAVITY

_GZ = float(GRAVITY[2])


# ---------------------------------------------------------------------------
# model/state pack-unpack at the module boundary
# ---------------------------------------------------------------------------

def _slab(a):
    """(N, J, K) -> (K, J, N)."""
    return a.permute(2, 1, 0).contiguous()


def _slab_m33(a):
    """(N, J, 3, 3) -> (3, 3, J, N)."""
    return a.permute(2, 3, 1, 0).contiguous()


def _aos(a):
    """(K, J, N) -> (N, J, K)."""
    return a.permute(2, 1, 0)


def _model_soa(model: ArticulationModel) -> Dict:
    """Unpack model arrays into slabs (loop-invariant: once per control
    step, outside the substep loop)."""
    msoa = dict(
        topo=model.topo,
        joint_pos=_slab(model.joint_pos),           # v3 slab (3, J, N)
        body_com=_slab(model.body_com),
        body_mass=model.body_mass.T.contiguous(),   # (J, N)
        kp=model.kp.T.contiguous(),                 # (J-1, N)
        kd=model.kd.T.contiguous(),
        torque_lim=model.torque_lim.T.contiguous(),
        armature=model.armature.T.contiguous(),
        contact_offset=_slab(model.contact_offset),  # v3 slab (3, P, N)
        contact_radius=model.contact_radius.T.contiguous(),  # (P, N)
    )
    # spatial inertia blocks about body origin, body frame (state-independent)
    msoa["I_sp"] = soa.sp_inertia(msoa["body_mass"], msoa["body_com"],
                                  _slab_m33(model.body_inertia))
    return msoa


def _state_soa(state: ArticulationState) -> Dict:
    return dict(
        root_pos=state.root_pos.T,
        root_quat=state.root_quat.T,
        root_w=state.root_vel[:, :3].T,
        root_v=state.root_vel[:, 3:].T,
        jq=_slab(state.joint_quat),      # q4 slab (4, J-1, N)
        jo=_slab(state.joint_omega),     # v3 slab (3, J-1, N)
    )


def _state_aos(s: Dict) -> ArticulationState:
    return ArticulationState(
        root_pos=s["root_pos"].T,
        root_quat=s["root_quat"].T,
        root_vel=torch.cat([s["root_w"], s["root_v"]], dim=0).T,
        joint_quat=_aos(s["jq"]),
        joint_omega=_aos(s["jo"]),
    )


def _pack_levels(lvls, order):
    """List over levels of (K, L, N) slabs -> (K, J', N) permuted by `order`
    (level-major concat → body order)."""
    return torch.cat(lvls, dim=1)[:, order]


# ---------------------------------------------------------------------------
# forward kinematics (per-level chain on slabs)
# ---------------------------------------------------------------------------

def _fk_levels(msoa: Dict, s: Dict):
    """Per-level world body lists (pos, quat, lin, ang), each a list over
    levels of (K, L, N) slabs. Parent lookups are gathers from the previous
    level's small slab."""
    topo = msoa["topo"]
    pos = [s["root_pos"][:, None]]
    quat = [s["root_quat"][:, None]]
    ang = [soa.q_rotate(s["root_quat"], s["root_w"])[:, None]]
    lin = [soa.q_rotate(s["root_quat"], s["root_v"])[:, None]]

    for d in range(1, len(topo.levels)):
        ids, jm1, pl = topo.levels[d], topo.joints[d], topo.par_loc[d]
        qp = quat[d - 1][:, pl]
        off_w = soa.q_rotate(qp, msoa["joint_pos"][:, ids])
        q_l = soa.q_mul_norm(qp, s["jq"][:, jm1])
        ang_p = ang[d - 1][:, pl]
        pos.append(pos[d - 1][:, pl] + off_w)
        quat.append(q_l)
        ang.append(ang_p + soa.q_rotate(q_l, s["jo"][:, jm1]))
        lin.append(lin[d - 1][:, pl] + soa.v_cross(ang_p, off_w))
    return pos, quat, lin, ang


def _fk_soa(msoa: Dict, s: Dict):
    """World body slabs: (pos (3,J,N), quat (4,J,N), lin, ang) in body order."""
    io = msoa["topo"].inv_order
    return tuple(_pack_levels(lv, io) for lv in _fk_levels(msoa, s))


def fk_world(model: ArticulationModel, state: ArticulationState):
    """Returns body_pos (N,J,3), body_quat (N,J,4), body_vel_w (N,J,3),
    body_ang_vel_w (N,J,3)."""
    return tuple(_aos(t) for t in _fk_soa(_model_soa(model), _state_soa(state)))


# ---------------------------------------------------------------------------
# contacts: penalty sphere-vs-ground → dense wrench slabs
# ---------------------------------------------------------------------------

def _contacts_soa(msoa: Dict, pos, quat, lin, ang, params: ContactParams, f_w, t_w):
    """Accumulate ground-plane penalty contact wrenches into the dense world
    wrench slabs (f_w, t_w), plus sphere-sphere self-collision over the
    model's static pair list."""
    topo = msoa["topo"]
    cb = topo.contact_body
    off_w = soa.q_rotate(quat[:, cb], msoa["contact_offset"])
    c_w = pos[:, cb] + off_w
    v_c = lin[:, cb] + soa.v_cross(ang[:, cb], off_w)

    pen = torch.clamp_min(msoa["contact_radius"] - c_w[2], 0.0)
    active = (pen > 0.0).to(pen.dtype)
    fn = params.kn * pen - params.dn * v_c[2] * active
    fn = torch.clamp_min(fn, 0.0) * active

    vt_norm = torch.sqrt(v_c[0] * v_c[0] + v_c[1] * v_c[1])
    ft_mag = torch.minimum(params.mu * fn, params.kt * vt_norm)
    sc = -ft_mag / torch.clamp_min(vt_norm, params.vt_eps)
    f_c = torch.stack((v_c[0] * sc, v_c[1] * sc, fn))
    t_c = soa.v_cross(off_w, f_c)
    f_w = f_w.index_add(1, cb, f_c)
    t_w = t_w.index_add(1, cb, t_c)

    if topo.num_pairs:
        f_w, t_w = _self_contacts_soa(msoa, off_w, c_w, v_c, params, f_w, t_w)
    return f_w, t_w


def _self_contacts_soa(msoa: Dict, off_w, c_w, v_c, params: ContactParams, f_w, t_w):
    """Sphere-sphere penalty contacts over the static curated pair list (the
    analogue of PhysX self-collision filter masks): arms deflect off the
    trunk instead of passing through."""
    topo = msoa["topo"]
    pi, pj = topo.pair_i, topo.pair_j
    d = c_w[:, pi] - c_w[:, pj]
    dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    n = d / torch.clamp_min(dist, 1e-6)
    radius = msoa["contact_radius"]
    pen = (radius[pi] + radius[pj]) - dist
    active = (pen > 0.0).to(pen.dtype)
    dv = v_c[:, pi] - v_c[:, pj]
    vn = dv[0] * n[0] + dv[1] * n[1] + dv[2] * n[2]
    # softer than the ground plane: body "flesh" compresses; damping keeps
    # the stiff PD arms from chattering against the trunk
    fn = torch.clamp_min(0.5 * params.kn * pen - params.dn * vn, 0.0) * active
    f = fn * n
    f_neg = -f
    f_w = f_w.index_add(1, topo.pair_body_i, f).index_add(1, topo.pair_body_j, f_neg)
    t_w = (t_w.index_add(1, topo.pair_body_i, soa.v_cross(off_w[:, pi], f))
           .index_add(1, topo.pair_body_j, soa.v_cross(off_w[:, pj], f_neg)))
    return f_w, t_w


# ---------------------------------------------------------------------------
# PD control (single slab op over all joints)
# ---------------------------------------------------------------------------

def _pd_torques_soa(msoa: Dict, s: Dict, pd_tar, dt: float):
    """Stable-PD proportional torque in exp-map coords (Tan et al. 2011):
        τ_p = kp · (q_tar − (q + dt·ω))
    The damping term is implicit inside ABA (D += (armature+dt·kd)I,
    u −= kd·ω), which keeps the stiff gains stable at large timesteps."""
    cur = soa.q_to_exp_map(s["jq"])
    lim = msoa["torque_lim"]
    return torch.clamp(msoa["kp"] * (pd_tar - cur - dt * s["jo"]), -lim, lim)


# ---------------------------------------------------------------------------
# ABA forward dynamics (block 3x3 form, per-level elimination)
# ---------------------------------------------------------------------------

def _aba_soa(msoa: Dict, s: Dict, tau, quat_w, f_ext_w, t_ext_w, dt: float,
             fixed_base: bool):
    """Articulated Body Algorithm over the static tree.

    tau (3, J-1, N): joint torques in child coords (stable-PD proportional
    part); f_ext_w/t_ext_w (3, J, N): world wrenches at body origins
    (contacts, residual root forces — gravity is added here). Joint damping
    kd is implicit: D += (armature + dt·kd)·I₃ and u −= kd·ω.

    Returns (a_root (ω̇, v̇) in root coords, qdd (3, J-1, N)).
    """
    topo = msoa["topo"]
    D_lv = len(topo.levels)
    jpos = msoa["joint_pos"]

    # --- joint transforms + velocities (pass 1, per level)
    E = [None] * D_lv          # parent→child rotation per level, (3,3,L,N)
    v_lv = [(s["root_w"][:, None], s["root_v"][:, None])]
    c_lv = [None]              # root has no velocity-product accel
    for d in range(1, D_lv):
        ids, jm1, pl = topo.levels[d], topo.joints[d], topo.par_loc[d]
        E_l = soa.m_T(soa.q_to_m33(s["jq"][:, jm1]))
        vJ = s["jo"][:, jm1]
        vp = (v_lv[d - 1][0][:, pl], v_lv[d - 1][1][:, pl])
        w_p, v_p = soa.sp_xform_motion(E_l, jpos[:, ids], vp)
        w_l = w_p + vJ
        E[d] = E_l
        v_lv.append((w_l, v_p))
        c_lv.append(soa.sp_cross_motion((w_l, v_p), (vJ, torch.zeros_like(vJ))))

    # --- bias forces, whole-tree slab op (body order):
    # pA = v ×* (I v) − f_ext (body frame, gravity included)
    io = topo.inv_order
    v_w = _pack_levels([lv[0] for lv in v_lv], io)
    v_v = _pack_levels([lv[1] for lv in v_lv], io)
    I_A, I_B, I_D = msoa["I_sp"]
    Iv = (soa.m_vec(I_A, v_w) + soa.m_vec(I_B, v_v),
          soa.mT_vec(I_B, v_w) + soa.m_vec(I_D, v_v))
    bias_n, bias_f = soa.sp_cross_force((v_w, v_v), Iv)

    fg_z = msoa["body_mass"] * _GZ
    com_w = soa.q_rotate(quat_w, msoa["body_com"])
    t_tot = torch.stack((t_ext_w[0] + com_w[1] * fg_z, t_ext_w[1] - com_w[0] * fg_z,
                         t_ext_w[2]))
    f_tot = torch.stack((f_ext_w[0], f_ext_w[1], f_ext_w[2] + fg_z))
    pA_n_all = bias_n - soa.q_rotate_inv(quat_w, t_tot)
    pA_f_all = bias_f - soa.q_rotate_inv(quat_w, f_tot)

    # --- pass 2: backward, eliminate joints per level (S = [I₃; 0]).
    # Accumulators per level carry the children's contributions; the only
    # scatter is the parent-level add, which also sums several same-level
    # children of one parent.
    accIA = [None] * D_lv      # (A, B, D) m33 slabs or None
    acc_p = [None] * D_lv      # (n, f) v3 slabs or None
    Dinv, UA, UB, u = [None] * D_lv, [None] * D_lv, [None] * D_lv, [None] * D_lv
    for d in range(D_lv - 1, 0, -1):
        ids, jm1 = topo.levels[d], topo.joints[d]
        A, B, D = I_A[:, :, ids], I_B[:, :, ids], I_D[:, :, ids]
        pn, pf = pA_n_all[:, ids], pA_f_all[:, ids]
        if accIA[d] is not None:
            A = A + accIA[d][0]
            B = B + accIA[d][1]
            D = D + accIA[d][2]
            pn = pn + acc_p[d][0]
            pf = pf + acc_p[d][1]

        d_diag = msoa["armature"][jm1] + dt * msoa["kd"][jm1]
        Dinv_l = soa.m_inv(soa.m_add_diag(A, d_diag))
        u_l = tau[:, jm1] - msoa["kd"][jm1] * s["jo"][:, jm1] - pn

        # Ia = IA − U Dinv Uᵀ (blocks, A/D symmetric)
        ADi = soa.m_mul(A, Dinv_l)
        Ia_A = A - soa.m_mulT(ADi, A)
        Ia_B = B - soa.m_mul(ADi, B)
        Ia_D = D - soa.m_mul(soa.mT_mul(B, Dinv_l), B)

        # pa = pA + Ia c + U Dinv u
        cw_l, cv_l = c_lv[d]
        Di_u = soa.m_vec(Dinv_l, u_l)
        pa_n = (pn + soa.m_vec(Ia_A, cw_l)) + (soa.m_vec(Ia_B, cv_l) + soa.m_vec(A, Di_u))
        pa_f = (pf + soa.mT_vec(Ia_B, cw_l)) + (soa.m_vec(Ia_D, cv_l) + soa.mT_vec(B, Di_u))

        p_l = jpos[:, ids]
        Ap, Bp, Dp = soa.sp_xform_inertia_to_parent(E[d], p_l, Ia_A, Ia_B, Ia_D)
        n_p, f_p = soa.sp_xform_force_to_parent(E[d], p_l, (pa_n, pa_f))

        Dinv[d], UA[d], UB[d], u[d] = Dinv_l, A, B, u_l

        pl = topo.par_loc[d]
        if accIA[d - 1] is None:
            zm = Ap.new_zeros((3, 3, topo.level_sizes[d - 1], Ap.shape[-1]))
            zv = pa_n.new_zeros((3, topo.level_sizes[d - 1], pa_n.shape[-1]))
            accIA[d - 1] = (zm, zm, zm)
            acc_p[d - 1] = (zv, zv)
        aA, aB, aD = accIA[d - 1]
        accIA[d - 1] = (aA.index_add(2, pl, Ap), aB.index_add(2, pl, Bp),
                        aD.index_add(2, pl, Dp))
        an, af = acc_p[d - 1]
        acc_p[d - 1] = (an.index_add(1, pl, n_p), af.index_add(1, pl, f_p))

    # --- base acceleration
    if fixed_base:
        z = torch.zeros_like(s["root_w"])
        a0 = (z, z)
    else:
        A0 = I_A[:, :, 0] + accIA[0][0][:, :, 0]
        B0 = I_B[:, :, 0] + accIA[0][1][:, :, 0]
        D0 = I_D[:, :, 0] + accIA[0][2][:, :, 0]
        pn0 = pA_n_all[:, 0] + acc_p[0][0][:, 0]
        pf0 = pA_f_all[:, 0] + acc_p[0][1][:, 0]
        a0 = soa.sp_solve_sym66(A0, B0, D0, -pn0, -pf0)

    # --- pass 3: forward, joint accelerations per level
    a_lv = [(a0[0][:, None], a0[1][:, None])]
    qdd_lv = []
    for d in range(1, D_lv):
        ids, pl = topo.levels[d], topo.par_loc[d]
        ap = (a_lv[d - 1][0][:, pl], a_lv[d - 1][1][:, pl])
        aw_p, av_p = soa.sp_xform_motion(E[d], jpos[:, ids], ap)
        a_pw = aw_p + c_lv[d][0]
        a_pv = av_p + c_lv[d][1]
        # qdd = Dinv (u − Uᵀ a) with Uᵀ a = A a_ω + B a_v
        rhs = u[d] - (soa.m_vec(UA[d], a_pw) + soa.m_vec(UB[d], a_pv))
        qdd_l = soa.m_vec(Dinv[d], rhs)
        qdd_lv.append(qdd_l)
        a_lv.append((a_pw + qdd_l, a_pv))

    return a0, _pack_levels(qdd_lv, topo.inv_joint_order)


# ---------------------------------------------------------------------------
# integration (single slab op)
# ---------------------------------------------------------------------------

def _integrate_soa(s: Dict, a0, qdd, dt: float) -> Dict:
    """Semi-implicit Euler in generalized coordinates, quaternion joints."""
    root_w = s["root_w"] + a0[0] * dt
    root_v = s["root_v"] + a0[1] * dt
    root_pos = s["root_pos"] + soa.q_rotate(s["root_quat"], root_v) * dt
    root_quat = soa.q_mul_norm(s["root_quat"], soa.exp_map_to_q(root_w * dt))

    jo = s["jo"] + qdd * dt
    jq = soa.q_mul_norm(s["jq"], soa.exp_map_to_q(jo * dt))
    return dict(root_pos=root_pos, root_quat=root_quat, root_w=root_w,
                root_v=root_v, jq=jq, jo=jo)


# ---------------------------------------------------------------------------
# full substep / control step
# ---------------------------------------------------------------------------

def _substep_soa(msoa: Dict, s: Dict, pd_tar, root_force, root_torque,
                 extra_f, extra_t, contact_params: ContactParams, dt: float,
                 fixed_base: bool) -> Dict:
    """One physics substep on slabs. root_force/torque (3, N): world wrenches
    on the pelvis, or None; extra_f/extra_t (3, J, N): world wrenches, or
    None."""
    pos, quat, lin, ang = _fk_soa(msoa, s)

    J, N = pos.shape[1], pos.shape[2]
    f_w = extra_f if extra_f is not None else pos.new_zeros((3, J, N))
    t_w = extra_t if extra_t is not None else pos.new_zeros((3, J, N))
    f_w, t_w = _contacts_soa(msoa, pos, quat, lin, ang, contact_params, f_w, t_w)
    if root_force is not None:
        f_w = torch.cat([f_w[:, :1] + root_force[:, None], f_w[:, 1:]], dim=1)
    if root_torque is not None:
        t_w = torch.cat([t_w[:, :1] + root_torque[:, None], t_w[:, 1:]], dim=1)

    tau = _pd_torques_soa(msoa, s, pd_tar, dt)
    a0, qdd = _aba_soa(msoa, s, tau, quat, f_w, t_w, dt, fixed_base)
    return _integrate_soa(s, a0, qdd, dt)


def _inputs_soa(model: ArticulationModel, state: ArticulationState, pd_targets,
                root_force_w, root_torque_w, extra_force_w, extra_torque_w):
    """The step's loop-invariant slabs: the model, the PD targets (3, J-1, N),
    the root wrenches (3, N) and the extra wrenches (3, J, N), each None when
    not given."""
    N = state.root_pos.shape[0]
    pd_tar = _slab(pd_targets.reshape(N, model.num_bodies - 1, 3))
    rf = root_force_w.T if root_force_w is not None else None
    rt = root_torque_w.T if root_torque_w is not None else None
    ef = _slab(extra_force_w) if extra_force_w is not None else None
    et = _slab(extra_torque_w) if extra_torque_w is not None else None
    return _model_soa(model), pd_tar, rf, rt, ef, et


def substep(model: ArticulationModel, state: ArticulationState, pd_targets,
            root_force_w=None, root_torque_w=None,
            contact_params: ContactParams = ContactParams(), dt: float = 1.0 / 240.0,
            extra_force_w=None, extra_torque_w=None, fixed_base: bool = False):
    """One physics substep of `dt`. Arguments as `control_step`'s;
    `fixed_base` pins the root (zero base acceleration)."""
    msoa, *inputs = _inputs_soa(model, state, pd_targets, root_force_w, root_torque_w,
                                extra_force_w, extra_torque_w)
    return _state_aos(_substep_soa(msoa, _state_soa(state), *inputs, contact_params, dt,
                                   fixed_base))


def control_step(model: ArticulationModel, state: ArticulationState, pd_targets,
                 root_force_w=None, root_torque_w=None, substeps: int = 4,
                 control_dt: float = 1.0 / 30.0,
                 contact_params: ContactParams = ContactParams(),
                 extra_force_w=None, extra_torque_w=None):
    """One control step = `substeps` physics substeps at control_dt/substeps.

    pd_targets (N, (J-1)*3) exp-map joint targets; root_force_w/root_torque_w
    (N, 3) world wrenches on the pelvis; extra_force_w/extra_torque_w
    (N, J, 3) per-body world wrenches held constant over the control step.
    """
    dt = control_dt / substeps
    msoa, *inputs = _inputs_soa(model, state, pd_targets, root_force_w, root_torque_w,
                                extra_force_w, extra_torque_w)
    s = _state_soa(state)
    for _ in range(substeps):
        s = _substep_soa(msoa, s, *inputs, contact_params, dt, False)
    return _state_aos(s)


# ---------------------------------------------------------------------------
# observation helpers: generalized state → Isaac-style tensors
# ---------------------------------------------------------------------------

def dof_pos(state: ArticulationState):
    """(N, (J-1)*3) exp-map joint coordinates."""
    em = Q.quat_to_exp_map(state.joint_quat)
    return em.reshape(em.shape[0], -1)


def dof_vel(state: ArticulationState):
    return state.joint_omega.reshape(state.joint_omega.shape[0], -1)


def rigid_body_state(model: ArticulationModel, state: ArticulationState):
    """World body states: (pos (N,J,3), quat (N,J,4), lin vel (N,J,3), ang vel (N,J,3))."""
    return fk_world(model, state)


def set_state_from_reference(model: ArticulationModel, root_pos, root_rot,
                             root_vel_w, root_ang_vel_w, dof_pos_flat, dof_vel_flat):
    """ArticulationState from reset quantities: world root pose/velocities +
    exp-map dofs."""
    N = root_pos.shape[0]
    J = model.num_bodies
    w_b = Q.quat_rotate_inverse(root_rot, root_ang_vel_w)
    v_b = Q.quat_rotate_inverse(root_rot, root_vel_w)
    return ArticulationState(
        root_pos=root_pos,
        root_quat=root_rot,
        root_vel=torch.cat([w_b, v_b], dim=-1),
        joint_quat=Q.exp_map_to_quat(dof_pos_flat.reshape(N, J - 1, 3)),
        joint_omega=dof_vel_flat.reshape(N, J - 1, 3),
    )
