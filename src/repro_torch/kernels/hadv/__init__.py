"""First-order upwind horizontal advection: plain version and CUDA kernel."""
