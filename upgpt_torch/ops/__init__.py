"""Ops: plain PyTorch layers, and the CUDA kernels with their twins."""
