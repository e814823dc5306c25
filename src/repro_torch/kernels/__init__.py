# Hand-written CUDA kernels for Hopper (csrc/) behind PyTorch wrappers.
