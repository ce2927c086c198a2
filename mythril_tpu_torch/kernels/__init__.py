"""Hand-written CUDA kernels for Hopper (sm_90a), their build and their
PyTorch wrappers."""
