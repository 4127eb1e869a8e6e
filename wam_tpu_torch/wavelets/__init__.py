"""Wavelet filters and 2D transforms (PyTorch port of `wam_tpu.wavelets`)."""
