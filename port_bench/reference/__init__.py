"""Plain references of the model families, one module each."""
