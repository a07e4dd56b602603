"""Dense decoder-only language model in PyTorch (the JAX package's ``models``)."""
