"""pipeline of the PyTorch port."""
