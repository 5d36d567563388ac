"""Build and bind the CUDA sources in `csrc/` (nvcc + ctypes)."""
