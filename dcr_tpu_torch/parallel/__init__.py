"""Part of the PyTorch port (see dcr_tpu_torch/__init__.py)."""
