"""RG-LRU linear recurrence: plain PyTorch version and CUDA kernel for Hopper."""
