"""Tennis pieces of the hierarchical task: court, racket, ball, MVAE player,
two-hand backhand IK."""
