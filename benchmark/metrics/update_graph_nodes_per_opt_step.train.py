"""Nodes of the CUDA graph that one optimizer step of a training epoch
replays (`StaticGraph.nodes` of the learner's update graph)."""


def read(ctx):
    st = getattr(ctx.agent, "_st", None)
    nodes = getattr(getattr(st, "update", None), "nodes", 0)
    return nodes or None
