from .ppo import ImitationPPO, PPOConfig, TrainState  # noqa: F401
