"""Plain PyTorch references of the benchmark's models. They import
neither JAX nor the program, and take only what the benchmark made."""
