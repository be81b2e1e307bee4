from .motion_lib import MotionLib, get_motion_state, sample_motions, sample_time  # noqa: F401
from . import amass, synthetic  # noqa: F401
