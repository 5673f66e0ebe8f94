"""Data helpers of the PyTorch port."""
