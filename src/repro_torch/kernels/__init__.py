"""Hand-written CUDA kernels (``csrc/``), their wrappers and their plain
PyTorch versions (``ref``)."""
