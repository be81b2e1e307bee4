"""Stub: the reference never runs the port's fused Adam (K1)."""


def fused_clip_adam_apply(*args, **kwargs):
    raise NotImplementedError("the reference steps with the optax-chain Adam only")
