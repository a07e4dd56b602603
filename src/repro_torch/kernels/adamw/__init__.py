"""AdamW's update of one leaf: plain PyTorch version and CUDA kernel for
Hopper."""
