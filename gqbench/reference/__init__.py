"""Plain PyTorch and NumPy reference of the benchmark cells; imports nothing of the measured program."""
