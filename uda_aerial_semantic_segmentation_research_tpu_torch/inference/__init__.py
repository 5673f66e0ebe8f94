"""Inference entry points of the PyTorch port."""
