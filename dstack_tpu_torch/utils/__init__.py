"""Host-side utilities of the PyTorch port (its own copies; nothing here
imports the JAX package)."""
