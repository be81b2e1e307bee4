from .humanoid_im import EnvState, HumanoidImConfig, HumanoidImEnv, StepOutput  # noqa: F401
from .tennis import TennisConfig, TennisEnv, TennisState  # noqa: F401
from .tennis_dual import DualTennisEnv  # noqa: F401
from . import obs  # noqa: F401
