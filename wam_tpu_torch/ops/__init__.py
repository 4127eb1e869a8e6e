"""Mosaic packing (PyTorch port of `wam_tpu.ops`)."""
