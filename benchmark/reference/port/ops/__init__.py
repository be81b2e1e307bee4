"""Plain versions of the port's kernels (K2, K3); see the package docstring."""
