"""Hand-written kernels for Hopper and their plain PyTorch versions."""
