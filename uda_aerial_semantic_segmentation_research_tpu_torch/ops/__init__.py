"""Operators of the PyTorch port: the CUDA kernels and their plain versions."""
