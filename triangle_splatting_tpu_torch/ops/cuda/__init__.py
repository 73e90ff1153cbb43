"""Hand-written CUDA kernels of the tile pipeline (``csrc/``), their
``ctypes`` wrappers and the plain PyTorch version beside each kernel."""
