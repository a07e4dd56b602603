"""Flash attention forward: plain PyTorch version and CUDA kernel for Hopper."""
