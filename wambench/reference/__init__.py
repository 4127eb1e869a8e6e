"""The plain PyTorch reference the benchmark checks the package against. It imports nothing of the package."""
