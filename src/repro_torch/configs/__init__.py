"""Model configurations: a copy of the JAX package's, with no JAX in it."""
