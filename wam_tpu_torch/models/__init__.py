"""Models and checkpoint ingestion (PyTorch port of `wam_tpu.models`)."""
