"""PyTorch and CUDA port of the Cluster Builder reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
and imports nothing of it.  Kernels that the JAX package writes in Pallas
for the TPU are written here by hand for Hopper (``kernels/*/csrc``).
"""
