"""Nodes of the CUDA graph that one env step of a training epoch replays
(`StaticGraph.nodes` of the learner's step graph)."""


def read(ctx):
    st = getattr(ctx.agent, "_st", None)
    nodes = getattr(getattr(st, "step", None), "nodes", 0)
    return nodes or None
