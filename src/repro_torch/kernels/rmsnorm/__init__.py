"""Fused RMS norm: plain PyTorch version and CUDA kernel for Hopper."""
