"""transform modules of the PyTorch port."""
