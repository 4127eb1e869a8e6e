"""Gradient engine and estimators (PyTorch port of `wam_tpu.core`)."""
