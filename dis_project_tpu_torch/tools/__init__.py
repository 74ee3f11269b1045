"""Measurement scripts of the PyTorch/CUDA port (run on a machine with a card)."""
