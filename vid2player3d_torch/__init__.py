"""vid2player3d_torch — the PyTorch/CUDA port of ``vid2player3d_tpu`` for one
NVIDIA H100.

The package mirrors the JAX package module for module (``core``, ``physics``,
``data``, ``envs``, ``learn``, ``ops``, ``utils``), so every module has an
obvious counterpart there. It never imports JAX or the JAX package: the JAX
package is the reference that ``tests/test_torch_*.py`` hold it against.

Entry points (``make_synthetic_motion_lib``, ``HumanoidImEnv``,
``ImitationPPO``) take an explicit ``device=``. Without one they run on the
card, and raise when there is none: they never drop to the CPU on their own.
The kernels written by hand for Hopper live in ``csrc/`` and are bound in
``ops/``.
"""

__version__ = "0.1.0"
