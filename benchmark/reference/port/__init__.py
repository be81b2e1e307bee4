"""A frozen copy of the port's plain PyTorch code, the benchmark's reference.

Taken from `vid2player3d_torch/` (see `benchmark/README.md` for the commit)
and changed only where the port would run a kernel of its own or a CUDA
graph: `ops/fk.py` and `ops/moe_linear.py` keep only the plain versions, on
any device; `ops/fused_adam.py` and `utils/graphs.py` are stubs that raise,
since the reference steps every epoch eagerly with the optax-chain Adam.
Later changes to the port do not reach this copy, so the benchmark judges
the port against the code it had when the benchmark was written.
"""
