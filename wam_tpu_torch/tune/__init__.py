"""Model-side optimisations of the port (counterpart of `wam_tpu.tune`):
the fused ReLU VJP (`fused_relu`)."""
