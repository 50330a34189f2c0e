"""CUDA kernels (``../csrc``), their plain PyTorch versions, and the
distance engine that routes pairs to them."""
