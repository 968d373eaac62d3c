"""Sparse layouts of the PyTorch port (block-bucketed + resident CSC)."""
