"""Diagnostic scripts of the PyTorch port, run on the card."""
