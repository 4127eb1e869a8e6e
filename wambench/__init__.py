"""The benchmark of wam_tpu_torch on one H100: see run.py and PERF.md."""
