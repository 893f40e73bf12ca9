"""COSMO vertical advection: plain version and CUDA kernel."""
