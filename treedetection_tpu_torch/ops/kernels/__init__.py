"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a count of its launches."""
