"""Dual-player rally environment: two coupled tennis players (PyTorch
counterpart of ``vid2player3d_tpu/envs/tennis_dual.py``).

Envs are paired lanes: even lane = near player, odd lane = far player. Each
lane simulates its own humanoid in its own near-side court frame; the
opponent's world is the mirror image through the net. The rally coupling:

- even lanes start in reaction (receiving the serve), odd lanes in recovery;
- a reset opens the rally with a serve synthesized at the odd lane's racket,
  mirrored into its partner's frame as the incoming ball;
- a player's contact flips the partner lane into reaction: the outgoing ball
  is mirrored through the net and flown into the partner's incoming 30 Hz
  trajectory, for every env every step (masked, never behind a host test);
  a hand-off that does not clear the net ends the rally;
- the rally ends for both lanes when either ends.

Both lanes live in one step: the hand-off is a gather by the lane swap
(`i ^ 1`). The per-lane policies (one per player identity) are routed by
lane parity in the learner (`V2PPPO` with `num_policies=2`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tennis import ball as B
from .tennis import TennisEnv, TennisState, _rows_where

_MIRROR = (-1.0, -1.0, 1.0)


class DualTennisEnv(TennisEnv):
    """Paired-lane rally env: an even `num_envs`, the full masked reset
    (`reset_candidates=0`, the serves are lane-paired); lane i's opponent is
    lane i ^ 1. The serve draws are `serve_u` (N, 3) uniforms in the reset
    draws, or the env's generator; `step_draws` holds them, and no
    step-level `ball_idx` or `near_jitter`."""

    def __init__(self, cfg, *args, **kw):
        if cfg.num_envs % 2:
            raise ValueError("dual mode pairs envs: num_envs must be even")
        if cfg.reset_candidates != 0:
            raise ValueError("dual mode requires reset_candidates=0 (lane-paired serves)")
        super().__init__(cfg, *args, **kw)
        N = cfg.num_envs
        self._swap = torch.arange(N, device=self.device) ^ 1
        self._lane = torch.arange(N, device=self.device) % 2
        self._mirror = torch.tensor(_MIRROR, device=self.device)
        # the serve's velocity box (m/s), made once: the step reads only
        # tensors that outlive it
        self._serve_lo = torch.tensor([-2.0, 28.0, 5.0], device=self.device)
        self._serve_hi = torch.tensor([2.0, 32.0, 8.0], device=self.device)

    def shard(self, mesh) -> "DualTennisEnv":
        """This rank's block of the envs (``TennisEnv.shard``); the pairs
        (i, i ^ 1) must stay inside a rank, so each rank's count is even."""
        N = self.cfg.num_envs
        if N % mesh.dp or (N // mesh.dp) % 2:
            raise ValueError(f"dual rallies pair envs inside a rank: {N} envs over {mesh.dp} "
                             "ranks must give each rank an even count")
        env = super().shard(mesh)
        n = env.cfg.num_envs
        env._swap = torch.arange(n, device=self.device) ^ 1
        env._lane = torch.arange(n, device=self.device) % 2
        return env

    def _init_tar_action(self, N) -> torch.Tensor:
        # even = near player receives first; odd waits for the hand-off
        return (1 - self._lane).to(torch.int32)

    def _post_reset(self, state: TennisState, draws=None) -> TennisState:
        """The rally opens with a serve from each odd (server) lane: the ball
        leaves its racket with velocity x in [-2, 2], y in [28, 32], z in
        [5, 8] m/s and 40 rad/s topspin; the even (receiving) lane gets that
        serve mirrored into its frame, flown into its incoming trajectory."""
        N = self.cfg.num_envs
        with torch.autograd.profiler.record_function("serve"):
            u = self._rand(draws, "serve_u", (N, 3))
            lo, hi = self._serve_lo, self._serve_hi
            serve_vel = torch.maximum(lo, u * (hi - lo) + lo)
            serve_pos = state.racket_pos
            vspin = torch.full((N,), 40.0 / (2 * np.pi), device=self.device)

            # each lane's serve, mirrored into its opponent's frame, is that
            # opponent's incoming ball
            pos_in = (serve_pos * self._mirror)[self._swap]
            vel_in = (serve_vel * self._mirror)[self._swap]
            vspin_in = vspin[self._swap]
            res = B.simulate_flight(pos_in, vel_in, vspin_in,
                                    num_frames=state.ball_traj.shape[1], p=self.ball_params)
        receiving = self._lane == 0
        return dataclasses.replace(
            state,
            ball_pos=_rows_where(receiving, pos_in, serve_pos),
            ball_vel=_rows_where(receiving, vel_in, serve_vel),
            ball_vspin=torch.where(receiving, vspin_in, vspin),
            ball_traj=_rows_where(receiving, res.traj, state.ball_traj))

    def _post_reset_draws(self, m: int, g: torch.Generator):
        return {"serve_u": torch.rand((m, 3), generator=g, device=self.device)}

    def _reaction_draws(self, n: int, g: torch.Generator):
        # the hand-off draws nothing
        return {}

    def _reaction_trigger(self, state: TennisState, tar_time, contact_now):
        # my reaction = the opponent just hit (not a timer)
        return contact_now[self._swap]

    def _reaction_ball(self, state: TennisState, draws, ball_state13, reaction_mask):
        """The partner's outgoing ball mirrored into this court's frame and
        flown into the full incoming trajectory, for every env (the caller
        masks it by the reaction transition). `ok` = the flight clears the
        net: a netted shot ends the rally under every reward configuration."""
        with torch.autograd.profiler.record_function("handoff"):
            pos, vel, vspin = B._state_to_launch(ball_state13[self._swap])
            pos_in, vel_in = pos * self._mirror, vel * self._mirror
            res = B.simulate_flight(pos_in, vel_in, vspin, num_frames=state.ball_traj.shape[1],
                                    p=self.ball_params)
        return res.traj, pos_in, vel_in, vspin, res.pass_net

    def _couple_done(self, terminate, done):
        # the rally ends for both lanes together
        return terminate | terminate[self._swap], done | done[self._swap]
