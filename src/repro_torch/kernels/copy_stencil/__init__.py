"""The COSMO copy stencil: plain version and CUDA kernel."""
