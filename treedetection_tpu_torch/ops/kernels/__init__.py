"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; ``treedetection_tpu_torch.build`` builds, launches and counts
them."""
