"""Tennis pieces of the hierarchical task: court, racket, ball, MVAE player,
two-hand backhand IK."""

from . import ball, court, player, racket
from .ball import (BallParams, TennisBallGenerator, aero_force, estimate_in, estimate_out,
                   simulate_flight)
from .racket import RACKET_GRIPS, racket_from_wrist, racket_with_fk

__all__ = [
    "ball", "court", "racket", "BallParams", "TennisBallGenerator",
    "aero_force", "estimate_in", "estimate_out", "simulate_flight",
    "RACKET_GRIPS", "racket_from_wrist", "racket_with_fk",
]
