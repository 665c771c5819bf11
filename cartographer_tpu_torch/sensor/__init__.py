"""sensor modules of the PyTorch port."""
