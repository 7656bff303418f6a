"""Hand-written CUDA kernels (sources in ``csrc/``), their ctypes bindings
and their plain PyTorch versions."""
