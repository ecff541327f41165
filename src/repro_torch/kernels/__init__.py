"""Hand-written Hopper kernels of the port, their wrappers and plain versions."""
