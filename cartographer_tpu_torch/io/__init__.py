"""io modules of the PyTorch port: the PCD reader and the scan-match testbed."""
