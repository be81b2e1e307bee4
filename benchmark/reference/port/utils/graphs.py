"""Stub: the reference runs every step eagerly and captures no CUDA graph."""


def counters():
    return ()


def tensor_key(tensors):
    raise NotImplementedError("the reference captures no CUDA graph")


def refresh(static, values):
    raise NotImplementedError("the reference captures no CUDA graph")


class StaticGraph:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the reference captures no CUDA graph")
