"""Hand-written Hopper kernels of the port (CUDA C++, built at first use)."""
