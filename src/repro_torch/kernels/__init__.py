"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, and the
plain PyTorch versions they are held against."""
