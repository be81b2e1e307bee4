"""Device resolution (`runtime`) and a stub of the port's CUDA graphs."""
