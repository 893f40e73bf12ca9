"""COSMO compound horizontal diffusion: plain version and CUDA kernel."""
