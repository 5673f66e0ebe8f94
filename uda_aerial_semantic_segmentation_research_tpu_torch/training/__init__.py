"""Step factories of the PyTorch port."""
