"""nvcc build + ctypes loading of the CUDA kernels under ``csrc/``."""
