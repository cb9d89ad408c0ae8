"""training steps of the PyTorch port (see the module docstrings)."""
