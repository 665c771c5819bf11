"""io modules of the PyTorch port: the PCD reader, the scan-match testbed, and
state interchange (pbstream framing, the native and reference formats, the
pbstream CLI)."""
