from .humanoid_im import EnvState, HumanoidImConfig, HumanoidImEnv, StepOutput  # noqa: F401
