from .frozen import FrozenImitator  # noqa: F401
from .ppo import ImitationPPO, PPOConfig, TrainState  # noqa: F401
from .v2p_ppo import V2PConfig, V2PPPO, V2PTrainState  # noqa: F401
from . import networks, running_norm  # noqa: F401
