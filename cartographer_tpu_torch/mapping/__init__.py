"""mapping modules of the PyTorch port."""
