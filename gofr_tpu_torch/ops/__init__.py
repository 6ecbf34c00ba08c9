"""Attention ops: hand-written CUDA kernels beside their plain PyTorch versions."""
