"""Evaluation and rollout export (counterpart of ``vid2player3d_tpu/eval.py``).

`evaluate(agent)` runs deterministic (mean-action) rollouts and reports:

- imitation agents: reward mean, the tracking sub-rewards, alive ratio,
  MPJPE, episode length and reward, success rate;
- tennis agents: hit rate, estimated bounce-in rate, bounce position error
  and forehand ratio, accumulated per swing cycle; a dual rally also per lane.

`export_rollout` / `export_imitation_rollout` write a host-side npz of
per-frame kinematics, the data that `vis.render_html` draws.

Each rollout writes its steps' records into (T, N, ...) buffers on the
device, which move to the host once, when the rollout (for imitation, the
segment) ends, as JAX's scanned rollouts do. Where the learner replays its
epoch from CUDA graphs (`agent.graphed`: the card, no mesh), each
evaluation step is one replay of a `StaticGraph` (``utils/graphs.py``) over
static tensors, the draws made outside it; elsewhere (the CPU, a mesh) the
step runs op by op from the host. Either way an evaluation steps the
agent's own env with no randomization noise (the `_dr` configs evaluate on
the base model and ball), and the context IK takes the full-confidence
context (`amass_im_corrupt`). The graphs and their buffers
are kept on the agent (`agent._eval_st`, one per record set), so a
repeated evaluation replays them. The JAX package resets from fixed keys
(1234, 4321, 11, 7); here each function resets from a torch generator
seeded with the same integer on a shallow copy of the agent's env that owns
it, so an evaluation never moves the env's own stream. `draws=` feeds the
reset's (and, for tennis, every step's) random draws instead, as the envs'
`draws=` take them.
"""

from __future__ import annotations

import copy
import functools
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .learn import running_norm as RN
from .parallel import mesh as PM
from .utils import graphs


def _seeded(env, seed: int):
    """A shallow copy of `env` drawing from a fresh generator seeded `seed`;
    its candidate resets (a cached copy of `env` that draws from `env`'s
    generator) are made anew from it."""
    env = copy.copy(env)
    env.generator = torch.Generator(device=env.device).manual_seed(seed)
    env._candidates = None
    return env


def _record_row(bufs: Dict[str, torch.Tensor], row: torch.Tensor, rec: Dict, T: int) -> None:
    """Write one step's records into row `row` (a (1,) long tensor) of the
    (T, ...) buffers `bufs`, made from the first step's records."""
    if not bufs:
        bufs.update({k: torch.empty((T,) + v.shape, dtype=v.dtype, device=v.device)
                     for k, v in rec.items()})
    for k, v in rec.items():
        bufs[k].index_copy_(0, row, v[None])


def _to_host(bufs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The record buffers as numpy copies (a graph's buffers are
    overwritten by its next rollout, on the CPU too)."""
    return {k: v.to("cpu", copy=True).numpy() for k, v in bufs.items()}


def _eval_statics(agent, record: Callable, shape: tuple, make: Callable[[], SimpleNamespace],
                  body: Callable) -> SimpleNamespace:
    """The graphed evaluation's statics of one record set: kept on the
    agent apart from its training statics, made anew when `shape` (steps,
    envs) changes. `make()` gives the state, obs and inputs; added here:
    the record buffers (`bufs`, made at the first step), the step's row
    (`row`) and the `StaticGraph` of `body(agent, st)` (`step`)."""
    st = agent._eval_st.get(record)
    if st is not None and st.shape == shape:
        return st
    agent._eval_st.pop(record, None)          # the old graph's pool goes first
    st = make()
    st.shape, st.record, st.bufs, st.params = shape, record, {}, None
    st.row = torch.zeros(1, dtype=torch.long, device=agent.device)
    st.step = graphs.StaticGraph(functools.partial(body, agent, st), agent.device)
    agent._eval_st[record] = st
    return st


def evaluate(agent, num_epochs: int = 5, steps_per_epoch: Optional[int] = None,
             ts=None, draws: Optional[Dict] = None) -> Dict[str, float]:
    from .learn.ppo import ImitationPPO
    from .learn.v2p_ppo import V2PPPO

    if isinstance(agent, ImitationPPO):
        return eval_imitation(agent, num_rollouts=num_epochs, ts=ts, draws=draws)
    if isinstance(agent, V2PPPO):
        return eval_tennis(agent, num_steps=(steps_per_epoch or 64) * num_epochs, ts=ts,
                           draws=draws)
    raise TypeError(f"don't know how to evaluate {type(agent)}")


# ---- imitation ----------------------------------------------------------------

def _imitation_resets(env, seed: int, n: int, draws: Optional[Dict]):
    """n resets of every env: from a generator seeded `seed`, or with
    `draws["motion_times"][i]` (and `draws["corrupt"][i]`) fed to the i-th."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    for i in range(n):
        yield env.reset_all(
            generator=gen,
            motion_times=None if draws is None else draws["motion_times"][i],
            corrupt_draws=None if draws is None or "corrupt" not in draws
            else draws["corrupt"][i])


def _imitation_segment(agent, env, ts, env_state, raw_obs, ctx_feat, L, record):
    """L steps of the mean action from one context window, each step's
    records `record(env_state, tar, out, body_pos)`: (the last state, the
    last obs, the records on the host). Replayed from a graph where the
    learner's epoch is (`agent.graphed`), else op by op."""
    seg = _imitation_segment_graphed if agent.graphed else _imitation_segment_eager
    return seg(agent, env, ts, env_state, raw_obs, ctx_feat, L, record)


@torch.no_grad()
def _imitation_segment_eager(agent, env, ts, env_state, raw_obs, ctx_feat, L, record):
    """`_imitation_segment` op by op from the host: the oracle of the
    graphed one, and the path off the card."""
    from .data import motion_lib as ML
    from .physics import engine

    bufs, row = {}, torch.zeros(1, dtype=torch.long, device=env.device)
    for t in range(L):
        _, _, mu, _, _ = agent._forward(ts.params, ts.obs_norm, raw_obs, ctx_feat, t)
        tar = ML.get_motion_state(env.lib, env.motion_ids, env_state.motion_times,
                                  adjust_height=True, ground_tolerance=env.cfg.ground_tolerance)
        env_state2, out = env.step(env_state, mu)
        bp = engine.fk_world(env.model, env_state2.sim)[0]
        _record_row(bufs, row, record(env_state, tar, out, bp), L)
        row.add_(1)
        env_state, raw_obs = env_state2, out.obs
    return env_state, raw_obs, _to_host(bufs)


@torch.no_grad()
def _imitation_segment_graphed(agent, env, ts, env_state, raw_obs, ctx_feat, L, record):
    """`_imitation_segment` with each step one replay of the record set's
    step graph (`_imitation_step`); the context frames copied in outside
    it. Returns the statics' state and obs, which the next segment of this
    record set overwrites."""
    from .learn.ppo import FRAME_DIM

    N = env.cfg.num_envs
    st = _eval_statics(agent, record, (L, N), lambda: SimpleNamespace(
        state=PM.tree_map(torch.clone, env_state), obs=raw_obs.clone(),
        obs_norm=RN.RunningNormState.create(agent.obs_dim, agent.device),
        frame=torch.empty(N, FRAME_DIM, device=agent.device)), _imitation_step)
    graphs.refresh(PM.tree_leaves((st.state, st.obs, st.obs_norm)),
                   PM.tree_leaves((env_state, raw_obs, ts.obs_norm)))
    st.params = ts.params
    st.row.zero_()
    key = graphs.tensor_key(list(ts.params.values()))
    pad = env.cfg.context_padding
    for t in range(L):
        st.frame.copy_(ctx_feat[:, pad + t])
        st.step(key)
    return st.state, st.obs, _to_host(st.bufs)


def _imitation_step(agent, st) -> None:
    """One evaluation step on the static tensors: the mean action on the
    static obs and context frame, the reference motion's state, `env.step`,
    the world FK, the records' row `row`, the new state and obs copied
    back."""
    from .data import motion_lib as ML
    from .physics import engine

    env = agent.env
    with torch.no_grad():
        _, _, mu, _, _ = agent._forward_frame(st.params, st.obs_norm, st.obs, st.frame)
        tar = ML.get_motion_state(env.lib, env.motion_ids, st.state.motion_times,
                                  adjust_height=True, ground_tolerance=env.cfg.ground_tolerance)
        state, out = env.step(st.state, mu)
        bp = engine.fk_world(env.model, state.sim)[0]
        _record_row(st.bufs, st.row, st.record(st.state, tar, out, bp), st.shape[0])
        st.row.add_(1)
        graphs.refresh(PM.tree_leaves((st.state, st.obs)), PM.tree_leaves((state, out.obs)))


def _im_eval_record(env_state, tar, out, bp):
    """`eval_imitation`'s records of one step."""
    alive = (env_state.reset_buf == 0).to(torch.float32)
    # dead or diverging envs can hold non-finite or finite-but-huge sim
    # states; both are masked out of the MPJPE with their own denominator
    mpjpe = torch.linalg.norm(bp - tar["rb_pos"], dim=-1).mean(-1)
    m_ok = ((alive > 0) & torch.isfinite(mpjpe) & (mpjpe < 1e3)).to(torch.float32)
    mpjpe = torch.where(m_ok > 0, mpjpe, 0.0)
    return dict(reward=out.reward, alive=alive, subs=out.sub_rewards, mpjpe=mpjpe,
                m_ok=m_ok, done=out.done, term=out.terminate)


def _im_export_record(env_state, tar, out, bp):
    """`export_imitation_rollout`'s records of one step."""
    return dict(body_pos=bp, ref_body_pos=tar["rb_pos"], done=out.done)


def eval_imitation(agent, num_rollouts: int = 5, ts=None, full_episode: bool = True,
                   max_steps: int = 288, draws: Optional[Dict] = None) -> Dict[str, float]:
    """Deterministic rollouts of the imitation policy.

    `full_episode=True` plays episodes to the motion's end in segments of
    `context_length` steps, rebuilding the context window between segments,
    and reports per-episode reward and length, the success rate (episodes
    that reached the motion's end rather than failing) and MPJPE (mean
    per-joint position error in meters against the reference motion) beside
    the sub-reward decomposition. `draws["motion_times"]` (num_rollouts, N)
    feeds the reset times."""
    env = agent.env
    ts = ts if ts is not None else agent.init_state()
    L = env.cfg.context_length if full_episode else agent.cfg.horizon

    n_seg = max(1, (max_steps + L - 1) // L) if full_episode else 1
    recs = []
    for env_state, raw_obs, ctx in _imitation_resets(env, 1234, num_rollouts, draws):
        for _ in range(n_seg):
            env_state, raw_obs, rec = _imitation_segment(agent, env, ts, env_state, raw_obs,
                                                         ctx["feat"], L, _im_eval_record)
            recs.append(rec)
            if full_episode:
                # the context is rebuilt between segments
                ctx = env.init_context(env_state.motion_times)
            if not np.any(rec["alive"]):
                break   # every env finished its episode

    rew, alive, subs, mpjpe, m_ok, done, term = (
        np.concatenate([r[k] for r in recs])
        for k in ("reward", "alive", "subs", "mpjpe", "m_ok", "done", "term"))
    denom = max(alive.sum(), 1.0)
    done_ct = max(float((done * alive).sum()), 1.0)
    report = {
        "reward_mean": float((rew * alive).sum() / denom),
        "alive_ratio": float(alive.mean()),
        "mpjpe": float(mpjpe.sum() / max(m_ok.sum(), 1.0)),
        "episode_len": float(alive.sum() / (num_rollouts * rew.shape[1])),
        "episode_reward": float((rew * alive).sum() / (num_rollouts * rew.shape[1])),
        # success = reached the motion's end, not a tracking failure
        "success_rate": float((done * (1.0 - term) * alive).sum() / done_ct),
    }
    for i, name in enumerate(("r_dof", "r_vel", "r_pos", "r_rot")):
        if i < subs.shape[-1]:
            report[name] = float((subs[..., i] * alive).sum() / denom)
    return report


# ---- tennis --------------------------------------------------------------------

def _tennis_rollout(agent, ts, seed: int, num_steps: int, draws: Optional[Dict], record):
    """Reset (seeded `seed`, or `draws["reset"]`) and `num_steps` steps of the
    mean action (each fed `draws["steps"][t]` when given), each step's
    records `record(env, state, out)`. Returns (the seeded env, the initial
    state's tar_action on the host, the records on the host). Replayed from
    a graph where the learner's epoch is (`agent.graphed`), else op by op."""
    roll = _tennis_rollout_graphed if agent.graphed else _tennis_rollout_eager
    return roll(agent, ts, seed, num_steps, draws, record)


def _tennis_reset(agent, seed: int, draws: Optional[Dict]):
    """(the seeded copy, its reset state and obs, the state's tar_action on
    the host, the fed steps' draws or None)."""
    env = _seeded(agent.env, seed)
    state, obs = env.reset_all(None if draws is None else draws.get("reset"))
    return env, state, obs, state.tar_action.cpu().numpy(), \
        None if draws is None else draws.get("steps")


@torch.no_grad()
def _tennis_rollout_eager(agent, ts, seed: int, num_steps: int, draws: Optional[Dict], record):
    """`_tennis_rollout` op by op from the host, stepping the seeded copy
    (its draws made inside `step`): the oracle of the graphed one, and the
    path off the card."""
    env, state, obs, tar0, steps = _tennis_reset(agent, seed, draws)
    bufs, row = {}, torch.zeros(1, dtype=torch.long, device=env.device)
    for t in range(num_steps):
        mu, _ = agent._forward(ts.params, ts.obs_norm, obs)
        state, out = env.step(state, mu, None if steps is None else steps[t])
        _record_row(bufs, row, record(env, state, out), num_steps)
        row.add_(1)
        obs = out.obs
    return env, tar0, _to_host(bufs)


@torch.no_grad()
def _tennis_rollout_graphed(agent, ts, seed: int, num_steps: int, draws: Optional[Dict],
                            record):
    """`_tennis_rollout` with each step one replay of the record set's step
    graph (`_tennis_step`): the reset eager on the seeded copy, each step's
    draws made outside the graph from the copy's generator by
    `agent.env.step_draws` (or fed), the agent's own env stepped on them."""
    from .learn.v2p_ppo import _copy_draws

    env, state, obs, tar0, steps = _tennis_reset(agent, seed, draws)
    dev = agent.device
    st = _eval_statics(agent, record, (num_steps, agent.env.cfg.num_envs),
                       lambda: SimpleNamespace(
                           state=PM.tree_map(torch.clone, state), obs=obs.clone(),
                           obs_norm=RN.RunningNormState.create(agent.obs_dim, dev),
                           # the step's draws, shaped by a throwaway generator's
                           draws=agent.env.step_draws(torch.Generator(dev))), _tennis_step)
    graphs.refresh(PM.tree_leaves((st.state, st.obs, st.obs_norm)),
                   PM.tree_leaves((state, obs, ts.obs_norm)))
    st.params = ts.params
    st.row.zero_()
    key = agent._step_key(ts.params)
    for t in range(num_steps):
        _copy_draws(st.draws, agent.env.step_draws(env.generator) if steps is None
                    else steps[t])
        st.step(key)
    return env, tar0, _to_host(st.bufs)


def _tennis_step(agent, st) -> None:
    """One evaluation step on the static tensors: the mean action on the
    static obs, `env.step` on the static draws, the records' row `row`, the
    new state and obs copied back."""
    with torch.no_grad():
        mu, _ = agent._forward(st.params, st.obs_norm, st.obs)
        state, out = agent.env.step(st.state, mu, st.draws)
        _record_row(st.bufs, st.row, st.record(agent.env, state, out), st.shape[0])
        st.row.add_(1)
        graphs.refresh(PM.tree_leaves((st.state, st.obs)), PM.tree_leaves((state, out.obs)))


def _tennis_eval_record(env, s, out):
    """`eval_tennis`'s records of one step."""
    return dict(done=out.done, tar_action=s.tar_action, contact=s.has_contact,
                est_in=s.est_bounce_in,
                est_err=torch.linalg.norm(s.est_bounce_pos - s.target_bounce[:, :2], dim=-1),
                swing=s.mvae.swing_type_cycle, root_pos=s.sim.root_pos, reward=out.reward)


def _tennis_export_record(env, s, out):
    """`export_rollout`'s records of one step."""
    from .physics import engine

    bp = engine.fk_world(env.model, s.sim)[0]
    return dict(root_pos=s.mvae.root_pos, joint_rotmat=s.mvae.joint_rotmat,
                phase=s.mvae.phase_pred, swing=s.mvae.swing_type, ball_pos=s.ball_pos,
                racket_pos=s.racket_pos, racket_normal=s.racket_normal,
                sim_root_pos=s.sim.root_pos, sim_root_quat=s.sim.root_quat,
                sim_joint_quat=s.sim.joint_quat, body_pos=bp, done=out.done,
                contact=s.has_contact, bounce_in=s.bounce_in)


def eval_tennis(agent, num_steps: int = 300, per_env: bool = False, ts=None,
                draws: Optional[Dict] = None):
    """Deterministic high-level policy rollout; behavioral stats accumulated
    per swing cycle (a cycle ends at a reaction -> recovery transition, or
    when an env finishes while in reaction): hit rate, estimated bounce-in
    rate, estimated bounce position error (on in-balls), forehand ratio.
    `draws={"reset": ..., "steps": [...]}` feeds the env's draws."""
    ts = ts if ts is not None else agent.init_state()
    env, tar0, rec = _tennis_rollout(agent, ts, 4321, num_steps, draws,
                                      _tennis_eval_record)

    ta = rec["tar_action"]                          # (T, N)
    ta_prev = np.concatenate([tar0[None], ta[:-1]], axis=0)
    cyc = (ta_prev == 1) & (ta == 0) & (rec["done"] == 0)
    # a terminated reaction with no contact is also a finished (missed) cycle
    cyc |= (rec["done"] == 1) & (ta_prev == 1)

    def cyc_rate(x, mask=cyc):
        m = mask.astype(np.float64)
        return (x * m).sum(0) / np.maximum(m.sum(0), 1e-9), m.sum(0)

    hit_pe, n_cyc = cyc_rate(rec["contact"])
    in_pe, _ = cyc_rate(rec["est_in"])
    fh_pe, _ = cyc_rate(rec["swing"] == 1)
    err_mask = cyc & rec["est_in"].astype(bool)
    err_pe, n_in = cyc_rate(rec["est_err"], err_mask)
    dist_pe = np.linalg.norm(np.diff(rec["root_pos"][..., :2], axis=0), axis=-1).sum(0)

    valid = n_cyc > 0
    stats_pe = dict(hit_rate=hit_pe, bounce_in_rate=in_pe, fh_ratio=fh_pe,
                    bounce_pos_error=err_pe, cycles=n_cyc, distance=dist_pe)
    report = {
        "cycles": int(n_cyc.sum()),
        "hit_rate": float(hit_pe[valid].mean()) if valid.any() else 0.0,
        "bounce_in_rate": float(in_pe[valid].mean()) if valid.any() else 0.0,
        # None (JSON null), not NaN, when no in-ball was recorded
        "bounce_pos_error": float(err_pe[n_in > 0].mean()) if (n_in > 0).any() else None,
        "fh_ratio": float(fh_pe[valid].mean()) if valid.any() else 0.0,
        "reward_mean": float(rec["reward"].mean()),
    }
    # dual rally: the stats per lane (even = player A, near; odd = player B,
    # far), which run different MVAEs, handedness and pi_low
    if getattr(env, "_lane", None) is not None:
        lane = env._lane.cpu().numpy()
        for name, m in (("lane_a", lane == 0), ("lane_b", lane == 1)):
            v = valid & m
            report[name] = {
                "cycles": int(n_cyc[m].sum()),
                "hit_rate": float(hit_pe[v].mean()) if v.any() else 0.0,
                "bounce_in_rate": float(in_pe[v].mean()) if v.any() else 0.0,
                "fh_ratio": float(fh_pe[v].mean()) if v.any() else 0.0,
                "bounce_pos_error": float(err_pe[m & (n_in > 0)].mean())
                if (m & (n_in > 0)).any() else None,
            }
    if per_env:
        return report, stats_pe
    return report


def select_best(stats_pe: Dict[str, np.ndarray], num: int = 1, bounce_in_min: float = 0.95,
                fh_max: float = 0.6) -> np.ndarray:
    """Rank envs for recording: keep envs with bounce-in rate > 0.95 and
    forehand ratio < 0.6, sorted by total root distance traveled,
    descending; all envs by distance when none qualifies."""
    cand = (stats_pe["bounce_in_rate"] > bounce_in_min) \
        & (stats_pe["fh_ratio"] < fh_max) & (stats_pe["cycles"] > 0)
    ids = np.nonzero(cand)[0]
    if ids.size == 0:
        ids = np.arange(len(stats_pe["distance"]))
    order = np.argsort(-stats_pe["distance"][ids])
    return ids[order][:num]


# ---- rollout export --------------------------------------------------------------

def export_imitation_rollout(agent, path: str, num_steps: int = 90, ts=None,
                             draws: Optional[Dict] = None) -> str:
    """Write a deterministic imitation rollout: the simulated body positions
    and the reference motion's as a ghost skeleton, in segments of one
    context window each (the context rebuilt between them). Renderable with
    `vis.render_html`. `draws["motion_times"][0]` feeds the reset times."""
    from .learn.ppo import ImitationPPO

    if not isinstance(agent, ImitationPPO):
        raise TypeError("imitation rollout export needs an ImitationPPO")
    env = agent.env
    ts = ts if ts is not None else agent.init_state()
    L = env.cfg.context_length
    env_state, raw_obs, ctx = next(_imitation_resets(env, 11, 1, draws))
    chunks = []
    for _ in range(max(1, (num_steps + L - 1) // L)):
        env_state, raw_obs, rec = _imitation_segment(agent, env, ts, env_state, raw_obs,
                                                     ctx["feat"], L, _im_export_record)
        chunks.append(rec)
        ctx = env.init_context(env_state.motion_times)
    rec = {k: np.concatenate([c[k] for c in chunks], 0)[:num_steps] for k in chunks[0]}
    rec["body_radius"] = env.model.contact_radius[0, :24].cpu().numpy()
    np.savez_compressed(path, **rec)
    return path


def export_rollout(agent, path: str, num_steps: int = 150, ts=None,
                   draws: Optional[Dict] = None) -> str:
    """Write a deterministic tennis rollout (per-frame MVAE and simulated
    kinematics, ball, racket, contacts) as npz for offline viewing. With a
    two-handed lane, the recorded backhand frames (swing 2, phase in (2, 5))
    of those lanes are refined after the rollout by the two-hand IK at 50
    iterations, one pass per racket hand. `draws` as in `eval_tennis`."""
    from .learn.v2p_ppo import V2PPPO

    if not isinstance(agent, V2PPPO):
        raise TypeError("rollout export currently targets tennis agents")
    ts = ts if ts is not None else agent.init_state()
    env, _, rec = _tennis_rollout(agent, ts, 7, num_steps, draws, _tennis_export_record)
    # static viewer extras: per-body geom radii (volumetric limbs) and the
    # racket-hand wrist (handle line)
    rec["body_radius"] = env.model.contact_radius[0, :24].cpu().numpy()
    rec["wrist_id"] = env.wrist_id.to(torch.int32).cpu().numpy()

    if env.any_two_hand:
        # post-hoc two-hand refinement of the recorded kinematics at the full
        # iteration count; only two-handed lanes refine, each with its own
        # handedness
        from .tennis import twohand

        T, N = rec["phase"].shape
        dev = env.device
        mask = (rec["swing"] == 2) & (rec["phase"] > 2.0) & (rec["phase"] < 5.0)
        mask &= env.two_hand_mask.cpu().numpy()[None]
        rest = env.rest_joints_smpl[None].expand(T, N, 24, 3).reshape(T * N, 24, 3)
        rh_env = np.broadcast_to(env.righthand.cpu().numpy()[None], (T, N))
        rm = torch.as_tensor(rec["joint_rotmat"].reshape(T * N, 24, 3, 3), device=dev)
        for rh in sorted({bool(sp.righthand) for sp, th
                          in zip(env._lane_specs, env._lane_two_hand) if th}):
            m = mask & (rh_env == rh)
            rm = twohand.optimize_two_hand_backhand(
                rm, rest, righthand=rh, iters=50,
                mask=torch.as_tensor(m.reshape(T * N), device=dev))
        rec["joint_rotmat"] = rm.cpu().numpy().reshape(T, N, 24, 3, 3)

    np.savez_compressed(path, **rec)
    return path
