"""The benchmark of the PyTorch + CUDA path tracer (see README.md)."""
