"""repro_torch.core: tile choice for the CUDA kernels."""
