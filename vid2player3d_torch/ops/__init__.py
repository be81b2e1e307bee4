"""The kernels written by hand for Hopper (``csrc/``) and their wrappers:
K1 `fused_adam`, K2 `moe_linear`, K3 `fk`. Importing them builds and loads
nothing: each wrapper builds its kernel at its first launch.

The package binds the function `moe_linear` over the submodule's name, as
the JAX package does; reach the module itself with
``importlib.import_module("vid2player3d_torch.ops.moe_linear")``.
"""

from vid2player3d_torch.ops.moe_linear import moe_linear, moe_linear_ref

__all__ = ["moe_linear", "moe_linear_ref"]
