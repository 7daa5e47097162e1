"""Device-side operators of the port (PyTorch, plus hand-written CUDA kernels)."""
